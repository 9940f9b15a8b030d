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
//     xs     = s − (2/h)·x     (formed once a call by the pre-pass, rounded
//                               as the plain version's torch ops round it)
//
// with hi(a) = bf16(a) and lo(a) = bf16(a − hi(a)), rounded to nearest even;
// the row-sum is over the unsplit f32 K.  The wrapper passes the norms ‖y‖²
// and ‖x‖², summed in torch as the plain version sums them: at the path's
// h = 1 φ rides the Gram diagonal, where d² is the small difference of
// three numbers near 2d, so the kernel and its plain version differ there
// only by the order of the y·xᵀ sums.
//
// What bounds it on this card: the tensor cores, and then issue.  A
// Covertype call (8 lanes × 1250 rows × 10,000, d = 55) is 1e8 pairs at
// 6·d bf16 flops a pair for each contraction, ~6.6e10 flops, 0.067 ms at
// the 989 TFLOP/s bf16 peak (mma.sync reaches part of it).  Everything
// else a pair — the norm form, clamp, exp, row-sum, K's hi/lo split and
// the f32 adds of the per-k-step partials — runs on the CUDA cores and
// takes issue slots beside the MMAs, so it must stay a few instructions a
// pair, and the operands must reach the tensor cores without a split or a
// scalar load per element.
//
// What the design does about it:
// - a pre-pass (phi_big_d_bf16x3_prepass, same launch) splits y, x and xs
//   (formed there from s and x) once a call into bf16 hi/lo planes in
//   wrapper-allocated scratch, rows padded with zeros to DP (a multiple of
//   16) plus 8 (so the eight rows of an ldmatrix hit distinct bank
//   groups), row counts padded to whole tiles, and ‖x‖² copied beside them
//   with +inf in a padding column (its K is then exactly 0: no masks in
//   the loop);
// - a block of BX_WARPS warps owns BX_ROWS output rows of one lane, each
//   warp BX_WARP_ROWS of them as m16 tiles that share every B fragment;
//   the block's y planes are staged once;
// - the x, xs and ‖x‖² tiles stream through a BX_STAGES-deep ring of
//   shared memory, one tile ahead of the MMAs, each a few contiguous bulk
//   copies (TMA, cp.async.bulk) that one thread starts and an mbarrier a
//   stage counts: a copy takes no thread's issue slots (per-thread 16-byte
//   cp.async cost ~7% of them, and the kernel 10% of its time);
// - fragments come from ldmatrix (.trans for xs, read row-major as the
//   drive's B operand), four 8×8 matrices an instruction: hi and lo of one
//   n-tile together;
// - per 16 columns of a tile: the warp's Gram slice (y·xᵀ, _dot3) in
//   mma.sync.m16n8k16, its f32 accumulator turned into K in registers
//   (norms, clamp, one ex2.approx.ftz with log2(e)/h folded into one scale,
//   row-sum) and, split into hi/lo, used as the A fragment of the drive's
//   k-step as it stands (the accumulator-to-A layout identity of
//   m16n8k16), so K never leaves registers;
// - in the Gram, each 16-deep k-step's three products go into a fresh
//   partial that is then added to the running f32 sum: the tensor cores'
//   f32 accumulation truncates, and a small fresh sum loses fewer bits than
//   adding every product into the large running one (the Gram's diagonal
//   cancels in y² + x² − 2·yx); the drive, which cancels nothing,
//   accumulates in the tensor core (7% faster on an H100, bitwise the same
//   at h = 1);
// - the m axis is split across `nsplit` blocks per row tile (the wrapper's
//   split at BX_BLOCKS_PER_SM) and phi_finalize (phi_common.cuh) reduces
//   the partials in a fixed order — deterministic, no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ot_common.cuh"  // ot_ex2, OT_LOG2E
#include "phi_common.cuh"

// The geometry, each the fastest of the values timed at the Covertype lanes
// on an H100 (tools/ot_ab.py): 4 warps of 32 rows (against 8 of 16 and 8
// of 32), 32-column tiles (against 16 and 64: at 32 the block's shared
// memory lets three blocks share an SM), 2 stages (against 3).
constexpr int BX_WARPS = 4;
constexpr int BX_WARP_ROWS = 32;  // output rows a warp: m16 tiles sharing B
constexpr int BX_ROWS = 128;      // output rows per block
constexpr int BX_COLS = 32;       // interaction rows per shared-memory tile
constexpr int BX_STAGES = 2;      // tiles in the shared-memory ring
// The m-split's target of blocks an SM that the wrapper gives this kernel
// (ops/cuda_svgd.py:_KERNELS), recorded beside the rows a block it was
// measured with (of 2, 4, 6, 8, 10, 12 and 16, 8 was the fastest).
constexpr int BX_BLOCKS_PER_SM = 8;
constexpr int BX_MAX_D = 128;  // the wrapper refuses larger d
constexpr int BX_DP_ALIGN = 16;  // d is padded with zeros to a multiple of this
constexpr int BX_ROW_PAD = 8;    // bf16 a padded row holds beyond DP
constexpr int BX_THREADS = 32 * BX_WARPS;
constexpr int BX_PRE_THREADS = 256;
constexpr int BX_MT = BX_WARP_ROWS / 16;
static_assert(BX_ROWS == BX_WARPS * BX_WARP_ROWS, "rows a block");
static_assert(BX_WARP_ROWS % 16 == 0 && BX_COLS % 16 == 0, "m16n8k16 tiles");

__host__ __device__ inline int bx_dp(int d) {
  return (d + BX_DP_ALIGN - 1) / BX_DP_ALIGN * BX_DP_ALIGN;
}

struct BxScratch {  // offsets in bytes, every region 16-byte aligned
  long long yh, yl, xh, xl, xsh, xsl, x2, total;
  int k_pad, m_pad, lb, sx;  // lb: bf16 a padded row
  __host__ __device__ BxScratch(int S, int k, int m, int d, int x_lane_stride) {
    k_pad = (k + BX_ROWS - 1) / BX_ROWS * BX_ROWS;
    m_pad = (m + BX_COLS - 1) / BX_COLS * BX_COLS;
    lb = bx_dp(d) + BX_ROW_PAD;
    sx = x_lane_stride ? S : 1;
    const long long py = 2LL * S * k_pad * lb;
    const long long px = 2LL * sx * m_pad * lb;
    const long long pxs = 2LL * S * m_pad * lb;
    yh = 0;
    yl = yh + py;
    xh = yl + py;
    xl = xh + px;
    xsh = xl + px;
    xsl = xsh + pxs;
    x2 = xsl + pxs;
    total = x2 + 4LL * sx * m_pad;
  }
};

// xs = s − (2/h)·x as the wrapper's torch ops round it: (2/h)·x, then the
// difference (c2 = 2·inv_h in f32 is torch's f32 scalar 2/h: a power of two
// times the same rounding).
__device__ __forceinline__ float drive_operand(float s, float x, float c2) {
  return __fsub_rn(s, __fmul_rn(c2, x));
}

// One thread a 16-byte chunk (8 features) of a padded row of y, then x,
// then xs (formed from s and x): split into hi and lo; the first chunk of
// an x row also copies ‖x‖² (+inf past m).
static __global__ void __launch_bounds__(BX_PRE_THREADS)
phi_big_d_bf16x3_prepass(const float* __restrict__ y, const float* __restrict__ x,
                         const float* __restrict__ s, const float* __restrict__ x2,
                         unsigned char* __restrict__ scratch, int S, int k, int m,
                         int d, int x_lane_stride, float c2) {
  const BxScratch sc(S, k, m, d, x_lane_stride);
  const int c8s = sc.lb / 8;
  const long long ry = (long long)S * sc.k_pad;
  const long long rx = (long long)sc.sx * sc.m_pad;
  const long long total = (ry + rx + (long long)S * sc.m_pad) * c8s;
  for (long long e = (long long)blockIdx.x * BX_PRE_THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * BX_PRE_THREADS) {
    long long row = e / c8s;
    const int c = 8 * (int)(e - row * c8s);
    const float* src;
    long long hi, lo;
    int n, npad;
    const bool is_x = row >= ry && row < ry + rx;
    const bool is_xs = row >= ry + rx;
    if (row < ry) {
      src = y, n = k, npad = sc.k_pad, hi = sc.yh, lo = sc.yl;
    } else if (is_x) {
      row -= ry;
      src = x, n = m, npad = sc.m_pad, hi = sc.xh, lo = sc.xl;
    } else {
      row -= ry + rx;
      src = s, n = m, npad = sc.m_pad, hi = sc.xsh, lo = sc.xsl;
    }
    const int l = (int)(row / npad);
    const int r = (int)(row - (long long)l * npad);
    const bool valid = r < n;
    const float* sr = src + ((long long)l * n + r) * d;
    const float* xr = x + ((long long)(x_lane_stride ? l : 0) * m + r) * d;
    uint32_t wh[4], wl[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c0 = c + 2 * t;
      float a = valid && c0 < d ? sr[c0] : 0.f;
      float b = valid && c0 + 1 < d ? sr[c0 + 1] : 0.f;
      if (is_xs) {
        a = valid && c0 < d ? drive_operand(a, xr[c0], c2) : 0.f;
        b = valid && c0 + 1 < d ? drive_operand(b, xr[c0 + 1], c2) : 0.f;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const __nv_bfloat162 w =
          __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
      wh[t] = *reinterpret_cast<const uint32_t*>(&h);
      wl[t] = *reinterpret_cast<const uint32_t*>(&w);
    }
    const long long at = 2 * (row * sc.lb + c);  // bytes into a plane
    *reinterpret_cast<uint4*>(scratch + hi + at) = make_uint4(wh[0], wh[1], wh[2], wh[3]);
    *reinterpret_cast<uint4*>(scratch + lo + at) = make_uint4(wl[0], wl[1], wl[2], wl[3]);
    if (is_x && c == 0)
      reinterpret_cast<float*>(scratch + sc.x2)[row] =
          valid ? x2[(long long)l * m + r] : INFINITY;
  }
}

__device__ __forceinline__ unsigned bx_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bx_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bx_smem(bar)) : "memory");
}
// One arrival that also expects `bytes` from the bulk copies below.
__device__ __forceinline__ void bx_bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bx_smem(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) global to shared by the copy engine, counted
// on `bar`.
__device__ __forceinline__ void bx_bulk(void* dst, const void* src, unsigned bytes,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(bx_smem(dst)),
      "l"(src), "r"(bytes), "r"(bx_smem(bar))
      : "memory");
}
// Wait for the phase of parity `parity` of `bar`; a copy that never lands
// faults the kernel after ~2^24 polls rather than hanging the card.
__device__ __forceinline__ void bx_bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (int poll = 0; poll < (1 << 24) && !done; ++poll)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bx_smem(bar)), "r"(parity)
        : "memory");
  if (!done) __trap();
}

// Four 8×8 bf16 matrices; lane L gives the row address of matrix L / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d (16×8, f32) = a (16×16, bf16, row) · b (16×8, bf16, col) + c.  Not
// volatile: registers in, registers out, so independent products can be
// interleaved.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The three passes of `_dot3` for one 16-deep k-step (b: hi b0, hi b1,
// lo b0, lo b1) into a fresh partial, then added to `acc` with f32
// round-to-nearest (FIRST: `acc` is the partial) — the Gram's form.
template <bool FIRST>
__device__ __forceinline__ void dot3_step(float (&acc)[4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4],
                                          const uint32_t (&b)[4]) {
  const float z[4] = {0.f, 0.f, 0.f, 0.f};
  float p[4];
  mma_bf16(p, ahi, b[0], b[1], z);
  mma_bf16(p, ahi, b[2], b[3], p);
  mma_bf16(p, alo, b[0], b[1], p);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = FIRST ? p[i] : acc[i] + p[i];
}

// The same three passes accumulated in the tensor core straight into `acc`
// — the drive's form: its sum cancels nothing (at h = 1 it is the
// diagonal's one term K_ii·xs_i, bitwise as with a fresh partial), so the
// f32 adds of a fresh partial buy it no accuracy.
__device__ __forceinline__ void dot3_accumulate(float (&acc)[4], const uint32_t (&ahi)[4],
                                                const uint32_t (&alo)[4],
                                                const uint32_t (&b)[4]) {
  mma_bf16(acc, ahi, b[0], b[1], acc);
  mma_bf16(acc, ahi, b[2], b[3], acc);
  mma_bf16(acc, alo, b[0], b[1], acc);
}

// Two f32 values as a bf16 pair (hi split) and the pair of their residuals.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int KD>
struct BxLayout {  // shared memory, in bf16 elements
  static constexpr int DP = 16 * KD;
  static constexpr int LB = DP + BX_ROW_PAD;
  static constexpr int Y_HI = 0;
  static constexpr int Y_LO = Y_HI + BX_ROWS * LB;
  static constexpr int RING = Y_LO + BX_ROWS * LB;
  // a stage: x hi, x lo, xs hi, xs lo (BX_COLS rows each), ‖x‖² (floats)
  static constexpr int X_HI = 0;
  static constexpr int X_LO = X_HI + BX_COLS * LB;
  static constexpr int XS_HI = X_LO + BX_COLS * LB;
  static constexpr int XS_LO = XS_HI + BX_COLS * LB;
  static constexpr int X2 = XS_LO + BX_COLS * LB;
  static constexpr int STAGE = X2 + 2 * BX_COLS;
  static constexpr int BARS = RING + BX_STAGES * STAGE;  // one mbarrier a stage
  static constexpr int TOTAL = BARS + 4 * BX_STAGES;
};

// KD: 16-deep k-steps of the Gram (d ≤ 16·KD); NT: 8-feature n-tiles of
// the drive (d ≤ 8·NT, 2·KD − 1 or 2·KD).
template <int KD, int NT>
__global__ void __launch_bounds__(BX_THREADS)
phi_big_d_bf16x3_partial(const unsigned char* __restrict__ scratch,
                         const float* __restrict__ y2, float* __restrict__ part, int S,
                         int k, int m, int d, int x_lane_stride, int chunk, float nsc) {
  using L = BxLayout<KD>;
  constexpr int LB = L::LB;
  const BxScratch sc(S, k, m, d, x_lane_stride);
  extern __shared__ uint4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;
  const int g = ln >> 2;  // fragment row group
  const int t4 = ln & 3;  // thread within the group
  const int wr = warp * BX_WARP_ROWS;
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = blockIdx.x * BX_ROWS;
  const int xl = x_lane_stride ? lane : 0;
  const long long yrow = (long long)lane * sc.k_pad + row0;
  const long long xrow = (long long)xl * sc.m_pad;
  const long long xsrow = (long long)lane * sc.m_pad;
  const int j0 = split * chunk;
  const int ntiles = (min(sc.m_pad, j0 + chunk) - j0) / BX_COLS;

  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::BARS);
  if (tid == 0) {
    for (int i = 0; i < BX_STAGES; ++i) bx_bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  constexpr unsigned plane = 2 * BX_COLS * LB;
  constexpr unsigned ybytes = 2 * BX_ROWS * LB;
  auto stage_tile = [&](int t) {  // thread 0 starts the copies of tile t
    if (t < ntiles && tid == 0) {
      __nv_bfloat16* st = sm + L::RING + (t % BX_STAGES) * L::STAGE;
      uint64_t* bar = bars + t % BX_STAGES;
      const long long jx = xrow + j0 + (long long)t * BX_COLS;
      const long long jxs = xsrow + j0 + (long long)t * BX_COLS;
      bx_bar_expect(bar, 4 * plane + 4 * BX_COLS + (t == 0 ? 2 * ybytes : 0));
      if (t == 0) {
        bx_bulk(sm + L::Y_HI, scratch + sc.yh + 2 * yrow * LB, ybytes, bar);
        bx_bulk(sm + L::Y_LO, scratch + sc.yl + 2 * yrow * LB, ybytes, bar);
      }
      bx_bulk(st + L::X_HI, scratch + sc.xh + 2 * jx * LB, plane, bar);
      bx_bulk(st + L::X_LO, scratch + sc.xl + 2 * jx * LB, plane, bar);
      bx_bulk(st + L::XS_HI, scratch + sc.xsh + 2 * jxs * LB, plane, bar);
      bx_bulk(st + L::XS_LO, scratch + sc.xsl + 2 * jxs * LB, plane, bar);
      bx_bulk(st + L::X2, scratch + sc.x2 + 4 * jx, 4 * BX_COLS, bar);
    }
  };
#pragma unroll
  for (int t = 0; t < BX_STAGES - 1; ++t) stage_tile(t);

  // the rows' norms: m-tile mt, rows g (h = 0) and g + 8 (h = 1)
  float y2r[BX_MT][2], ks[BX_MT][2];
#pragma unroll
  for (int mt = 0; mt < BX_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + wr + 16 * mt + g + 8 * h;
      y2r[mt][h] = i < k ? y2[(long long)lane * k + i] : 0.f;
      ks[mt][h] = 0.f;
    }
  float acc[BX_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < BX_MT; ++mt)
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][q][i] = 0.f;

  // ldmatrix row addresses (lane ln gives a row of matrix ln / 8)
  const __nv_bfloat16* ya = sm + L::Y_HI + (wr + (ln & 15)) * LB + (ln >> 4) * 8;
  constexpr int YPLANE = L::Y_LO - L::Y_HI;
  // x as the Gram's B: matrices (hi, k 0-7), (hi, k 8-15), (lo, 0-7), (lo, 8-15)
  const int xb = (ln >> 4) * (L::X_LO - L::X_HI) + (ln & 7) * LB + ((ln >> 3) & 1) * 8;
  // xs as the drive's B, transposed: (hi, j 0-7), (hi, j 8-15), (lo, ...)
  const int xsb = L::XS_HI + (ln >> 4) * (L::XS_LO - L::XS_HI) + (ln & 15) * LB;

  for (int t = 0; t < ntiles; ++t) {
    stage_tile(t + BX_STAGES - 1);
    bx_bar_wait(bars + t % BX_STAGES, (t / BX_STAGES) & 1);  // tile t (and y) landed
    const __nv_bfloat16* st = sm + L::RING + (t % BX_STAGES) * L::STAGE;
    const float* sx2 = reinterpret_cast<const float*>(st + L::X2);
#pragma unroll 1
    for (int kk = 0; kk < BX_COLS / 16; ++kk) {
      // the warp's Gram slice: its rows × columns 16·kk .. 16·kk + 15
      float gs[BX_MT][2][4];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ahi[BX_MT][4], alo[BX_MT][4];
#pragma unroll
        for (int mt = 0; mt < BX_MT; ++mt) {
          ldsm_x4(ahi[mt], ya + mt * 16 * LB + kd * 16);
          ldsm_x4(alo[mt], ya + YPLANE + mt * 16 * LB + kd * 16);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t b[4];
          ldsm_x4(b, st + xb + (16 * kk + 8 * n) * LB + kd * 16);
#pragma unroll
          for (int mt = 0; mt < BX_MT; ++mt) {
            if (kd == 0)
              dot3_step<true>(gs[mt][n], ahi[mt], alo[mt], b);
            else
              dot3_step<false>(gs[mt][n], ahi[mt], alo[mt], b);
          }
        }
      }
      // K in registers: norms, clamp, exp, row-sums, then hi/lo as the
      // drive's A fragments (n-tile n → registers 2n, 2n + 1)
      uint32_t khi[BX_MT][4], klo[BX_MT][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 x2v = *reinterpret_cast<const float2*>(sx2 + 16 * kk + 8 * n + 2 * t4);
#pragma unroll
        for (int mt = 0; mt < BX_MT; ++mt) {
          float kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // (y² + x²) − 2·yx, the plain version's order (2·yx is exact)
            const float s2 = __fadd_rn(y2r[mt][i >> 1], (i & 1) ? x2v.y : x2v.x);
            const float d2 = fmaxf(fmaf(-2.f, gs[mt][n][i], s2), 0.f);
            kv[i] = ot_ex2(d2 * nsc);
            ks[mt][i >> 1] += kv[i];
          }
          split_pair(kv[0], kv[1], khi[mt][2 * n], klo[mt][2 * n]);
          split_pair(kv[2], kv[3], khi[mt][2 * n + 1], klo[mt][2 * n + 1]);
        }
      }
      // the drive's k-step: K (rows × these 16 columns) · xs (16 × DP)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        uint32_t b[4];
        ldsm_x4_trans(b, st + xsb + 16 * kk * LB + 8 * q);
#pragma unroll
        for (int mt = 0; mt < BX_MT; ++mt) dot3_accumulate(acc[mt][q], khi[mt], klo[mt], b);
      }
    }
    __syncthreads();  // this stage is free for the tile BX_STAGES ahead
  }

  // the four threads of a row group hold disjoint columns: combine the
  // row-sums in a fixed order
#pragma unroll
  for (int mt = 0; mt < BX_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ks[mt][h] += __shfl_xor_sync(0xffffffffu, ks[mt][h], 1);
      ks[mt][h] += __shfl_xor_sync(0xffffffffu, ks[mt][h], 2);
    }
#pragma unroll
  for (int mt = 0; mt < BX_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + wr + 16 * mt + g + 8 * h;
      if (i >= k) continue;
      float* pr = part + (((long long)split * S + lane) * k + i) * (d + 1);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int c = q * 8 + 2 * t4;
        if (c < d) pr[c] = acc[mt][q][2 * h];
        if (c + 1 < d) pr[c + 1] = acc[mt][q][2 * h + 1];
      }
      if (t4 == 0) pr[d] = ks[mt][h];
    }
}

template <int KD, int NT>
static cudaError_t launch_partial(const unsigned char* scratch, const float* y2,
                                  float* part, int S, int k, int m, int d,
                                  int x_lane_stride, int chunk, int nsplit, float nsc,
                                  cudaStream_t stream) {
  const size_t smem = 2 * (size_t)BxLayout<KD>::TOTAL;
  static bool ready[64] = {};  // the attribute, set once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(phi_big_d_bf16x3_partial<KD, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((k + BX_ROWS - 1) / BX_ROWS, S, nsplit);
  phi_big_d_bf16x3_partial<KD, NT><<<grid, BX_THREADS, smem, stream>>>(
      scratch, y2, part, S, k, m, d, x_lane_stride, chunk, nsc);
  return cudaGetLastError();
}

// Bytes of scratch the launch below needs (ops/cuda_svgd.py computes the
// same from BX_ROWS, BX_COLS, BX_DP_ALIGN and BX_ROW_PAD, and chip_smoke.py
// checks the two).
extern "C" long long phi_big_d_bf16x3_scratch_bytes(int S, int k, int m, int d,
                                                    int x_lane_stride) {
  return BxScratch(S, k, m, d, x_lane_stride).total;
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// s (S, m, d) the scores; y2 (S, k) and x2 (m) or (S, m) the row norms ‖·‖²;
// scratch
// phi_big_d_bf16x3_scratch_bytes() bytes, 16-byte aligned; part (nsplit, S,
// k, d + 1) scratch; out (S, k, d).  All f32, contiguous, on `device`;
// 8 < d ≤ 128; chunk a multiple of BX_COLS.  Launches the pre-pass, the
// partial sums and the finalize on `stream`, allocates nothing, does not
// synchronise; returns the cudaGetLastError() code.
extern "C" int phi_big_d_bf16x3_launch(const void* y, const void* x, const void* s,
                                       const void* y2, const void* x2, void* scratch,
                                       void* part, void* out, int S, int k, int m,
                                       int d, int x_lane_stride, int chunk, int nsplit,
                                       float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > BX_MAX_D || chunk % BX_COLS) return (int)cudaErrorInvalidValue;
  unsigned char* bscratch = static_cast<unsigned char*>(scratch);
  const float* fy2 = static_cast<const float*>(y2);
  float* fpart = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BxScratch sc(S, k, m, d, x_lane_stride);
  const long long chunks =
      ((long long)S * sc.k_pad + (long long)sc.sx * sc.m_pad + (long long)S * sc.m_pad) *
      (sc.lb / 8);
  const long long want = (chunks + BX_PRE_THREADS - 1) / BX_PRE_THREADS;
  phi_big_d_bf16x3_prepass<<<(unsigned)(want < 8192 ? want : 8192), BX_PRE_THREADS, 0,
                             st>>>(
      static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<const float*>(s), static_cast<const float*>(x2), bscratch, S, k, m,
      d, x_lane_stride, 2.0f * inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float nsc = -OT_LOG2E * inv_h;
#define PHI_BF16X3_CASE(KD)                                                      \
  case KD:                                                                       \
    err = (d + 7) / 8 == 2 * KD                                                  \
              ? launch_partial<KD, 2 * KD>(bscratch, fy2, fpart, S, k, m, d,     \
                                           x_lane_stride, chunk, nsplit, nsc, st) \
              : launch_partial<KD, 2 * KD - 1>(bscratch, fy2, fpart, S, k, m, d, \
                                               x_lane_stride, chunk, nsplit, nsc, \
                                               st);                              \
    break;
  switch (bx_dp(d) / 16) {
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
  if (err != cudaSuccess) return (int)err;
  return (int)launch_phi_finalize(fpart, static_cast<const float*>(y),
                                  static_cast<float*>(out), nsplit, S, k, d, m, inv_h,
                                  st);
}
