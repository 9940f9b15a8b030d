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
//     K_ij   = exp(−d²_ij / h)                             (f32)
//     φ(y_i) = (_dot3(K, xs)_i + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once a call by the pre-pass, rounded
//                               as the plain version's torch ops round it)
//
// with hi(a) = bf16(a) and lo(a) = bf16(a − hi(a)), rounded to nearest even;
// the row-sum is over the unsplit f32 K.  The norms are f32 sums of short
// FMA chains, taken by the pre-pass (the plain version sums them in
// torch): at the BNN's h = 1, φ rides the Gram diagonal, where d² is the
// small difference of three numbers near 2‖y‖², so both sides keep their
// norms and their y·xᵀ sums accurate to a few ulps.
//
// What bounds it on this card: the tensor cores, and then issue.  A call is
// 12·d bf16 flops a pair (three products of depth d for the distance and
// three for the drive): 2.3e9 at the BNN's one lane (500 × 500, d = 753),
// 9e11 at 8 lanes × 1250 × 10,000.  The norm form, clamp, exp, row-sum, K's
// hi/lo split and the f32 adds of the per-k-step partials run on the CUDA
// cores beside the MMAs.
//
// What the design does about it — warpgroup MMAs (wgmma) fed by a producer
// warp, with the feature axis split across the blocks of a thread-block
// cluster:
// - a row block's drive accumulator is rows × d f32 (128 × 768 at d = 753,
//   384 KB), far more than one block's registers, so d is cut into C ≤ 8
//   slices of ws = WX_SLICE (WX_WIDE_SLICE beyond WX_NARROW_MAX_D) features,
//   one a block, and the C blocks of a row block form a cluster; a slice's
//   width is a compile-time constant, so the k-steps over it are unrolled
//   with no bounds of their own (the last slice is padded with zeros);
// - a pre-pass (phi_wide_d_bf16x3_prepass, same launch) splits y, x and xs
//   (formed there from s and x) once a call into bf16 hi/lo planes in
//   wrapper-allocated scratch, slice by slice, in the layout wgmma reads
//   from shared memory without swizzling: a tile of R rows (a block's rows
//   of y, WX_COLS of x and xs) is contiguous, as ws/8 columns of R 16-byte
//   rows of 8 features (so every 8 × 8 core matrix is 128 contiguous
//   bytes); row counts padded to whole tiles; it also takes ‖y‖² and ‖x‖²
//   (+inf in a padding column, whose K is then exactly 0: no masks);
// - a block is two consumer warpgroups and a producer warpgroup (which
//   hands its registers to the consumers): one thread of it stages the block's y planes once and keeps the x, xs
//   and ‖x‖² tiles of the next tiles in flight in a ring of WX_BUFFERS
//   (WX_WIDE_BUFFERS) buffers by bulk copies (TMA, cp.async.bulk), each
//   counted on a "full" mbarrier, and reuses a buffer once the consumers'
//   eight warps have arrived on its "empty" mbarrier; every wait is bounded
//   and faults rather than hangs;
// - up to WX_NARROW_MAX_D the warpgroups take 64 rows each of the block's
//   128; beyond, both take the block's 64 rows, each half of a tile's
//   columns in the Gram and half of the slice in the drive;
// - per tile, each warpgroup forms its Gram partial over the block's slice
//   with wgmma.m64nNk16 (A = y, B = x, both from shared memory by
//   descriptor), each 16-deep k-step's three products into a fresh partial
//   then added to the running f32 sum (the tensor cores' accumulation
//   truncates; the diagonal cancels in y² + x² − 2·yx), two k-steps in
//   flight; the tile's accumulator fragments are dealt out to the slices,
//   and each block pushes every fragment of its partial into the shared
//   memory of the fragment's owner (st.async, distributed shared memory,
//   counted on the owner's mbarrier: a sender never waits for its stores);
//   once they are in, each owner sums its fragments' C partials in slice
//   order (no float atomics), forms their K (norms, clamp, one
//   ex2.approx.ftz with log2(e)/h folded into one scale) and pushes it to
//   every block — no cluster barrier in the loop, slots and K
//   double-buffered;
// - once a tile's K is in, each thread reads the K of its own rows
//   (row-sums over the unsplit f32 K), splits it into hi/lo and passes it
//   as the register A operand of the drive's three wgmma products per
//   16 columns (the accumulator layout of the Gram is the A layout of the
//   drive); B is the xs tile, transposed from shared memory; the drive's
//   accumulators stay in registers for the whole m range, and its MMAs run
//   while the block forms the next tile's K (mma.sync on ldmatrix
//   fragments, 8 warps and the same exchange, measured 1.2× slower at 8 ×
//   1250 × 10,000 and 1.03–1.06× at the BNN's lane, 4% faster at its
//   8-shard lanes: tools/ot_ab.py on an H100);
// - the m axis is split across `nsplit` clusters per row block (the
//   wrapper's split at WX_BLOCKS_PER_SM, counting every block of a
//   cluster) and phi_finalize (phi_common.cuh) reduces the partials in a
//   fixed order — deterministic, no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ot_common.cuh"  // ot_ex2, OT_LOG2E
#include "phi_common.cuh"

constexpr int WX_CONSUMERS = 2;                    // warpgroups that run the MMAs
constexpr int WX_CTHREADS = 128 * WX_CONSUMERS;    // their threads
constexpr int WX_THREADS = WX_CTHREADS + 128;      // and a producer warpgroup
// Registers a thread of a consumer and of the producer warpgroup (setmaxnreg:
// the producer gives back what the consumers' accumulators take; the
// register file is allotted a warpgroup at a time).
constexpr int WX_CONSUMER_REGS = 232;
constexpr int WX_PRODUCER_REGS = 40;
static_assert(WX_CTHREADS * WX_CONSUMER_REGS + 128 * WX_PRODUCER_REGS <= 65536,
              "the register file");
constexpr int WX_COLS = 32;  // interaction rows per shared-memory tile
// Up to d = WX_NARROW_MAX_D: WX_ROWS output rows a block (64 a warpgroup),
// d-slices of WX_SLICE features, a ring of WX_BUFFERS buffers of a tile's x
// and of its xs; beyond, WX_WIDE_ROWS (the warpgroups share them), slices of
// WX_WIDE_SLICE and WX_WIDE_BUFFERS.  Measured on an H100 at d = 753
// (tools/ot_ab.py): 3 buffers alike to 2; slices of 256 (64 rows, clusters
// of 3) slower at 8 × 1250 × 10,000.
constexpr int WX_ROWS = 128;
constexpr int WX_SLICE = 128;
constexpr int WX_BUFFERS = 2;
constexpr int WX_WIDE_ROWS = 64;
constexpr int WX_WIDE_SLICE = 320;
constexpr int WX_WIDE_BUFFERS = 1;
constexpr int WX_NARROW_MAX_D = 1024;
constexpr int WX_MAX_SLICES = 8;  // blocks a cluster: the portable maximum
// The m-split's target of blocks an SM that the wrapper gives this kernel
// (ops/cuda_svgd.py:_KERNELS), counting every block of a cluster; one block
// fits an SM.  Of 1 and 2 measured on an H100 (tools/ot_ab.py), 1 the
// fastest at the BNN's 8-shard lanes, the two alike elsewhere.
constexpr int WX_BLOCKS_PER_SM = 1;
constexpr int WX_MAX_D = 2432;   // fits_vmem_big_d's largest d
constexpr int WX_PRE_THREADS = 256;
static_assert(WX_COLS == 32, "a tile is two k-steps of the drive");
static_assert(WX_SLICE % 16 == 0 && WX_WIDE_SLICE % (16 * WX_CONSUMERS) == 0,
              "whole k-steps, and halves of whole n-tiles");
static_assert(WX_ROWS == 64 * WX_CONSUMERS && WX_WIDE_ROWS == 64,
              "a warpgroup's MMAs take 64 rows");

// The d-slices: d cut into c slices of ws features (the last padded with
// zeros); the rows of a block.
struct WxSlices {
  int c, ws, rows;
  __host__ __device__ explicit WxSlices(int d) {
    const bool narrow = d <= WX_NARROW_MAX_D;
    ws = narrow ? WX_SLICE : WX_WIDE_SLICE;
    c = (d + ws - 1) / ws;
    rows = narrow ? WX_ROWS : WX_WIDE_ROWS;
  }
};

struct WxScratch {  // offsets in bytes, every region 16-byte aligned
  long long yh, yl, xh, xl, xsh, xsl, y2, x2, total;
  int k_pad, m_pad, sx;
  WxSlices sl;
  __host__ __device__ WxScratch(int S, int k, int m, int d, int x_lane_stride) : sl(d) {
    k_pad = (k + sl.rows - 1) / sl.rows * sl.rows;
    m_pad = (m + WX_COLS - 1) / WX_COLS * WX_COLS;
    sx = x_lane_stride ? S : 1;
    // slice-major (slice, lane, row) planes of ws bf16 a row, a tile of R
    // rows stored column by column of 8 features; then ‖y‖² (lane, row) and
    // ‖x‖² (x lane, row)
    const long long py = 2LL * sl.c * S * k_pad * sl.ws;
    const long long px = 2LL * sl.c * sx * m_pad * sl.ws;
    const long long pxs = 2LL * sl.c * S * m_pad * sl.ws;
    yh = 0;
    yl = yh + py;
    xh = yl + py;
    xl = xh + px;
    xsh = xl + px;
    xsl = xsh + pxs;
    y2 = xsl + pxs;
    x2 = y2 + 4LL * S * k_pad;
    total = x2 + 4LL * sx * m_pad;
  }
};

// xs = s − (2/h)·x as the wrapper's torch ops round it: (2/h)·x, then the
// difference (c2 = 2·inv_h in f32 is torch's f32 scalar 2/h: a power of two
// times the same rounding).
__device__ __forceinline__ float drive_operand(float s, float x, float c2) {
  return __fsub_rn(s, __fmul_rn(c2, x));
}

// Blocks [0, nn) take the norms of the padded y rows, then of the x rows,
// one warp a row (a lane's FMA chain over every 32nd feature, the lanes
// summed by a fixed shuffle tree); the rest split one 16-byte chunk (8
// features of a padded slice row) of y, x or xs (formed from s and x) into
// hi and lo, one thread a chunk, in the planes' own order (so that the
// stores coalesce).
static __global__ void __launch_bounds__(WX_PRE_THREADS)
phi_wide_d_bf16x3_prepass(const float* __restrict__ y, const float* __restrict__ x,
                          const float* __restrict__ s, unsigned char* __restrict__ scratch,
                          int S, int k, int m, int d, int x_lane_stride, int nn,
                          float c2) {
  const WxScratch sc(S, k, m, d, x_lane_stride);
  const long long ny = (long long)S * sc.k_pad;
  const long long nx = (long long)sc.sx * sc.m_pad;
  if ((int)blockIdx.x < nn) {
    long long row = (long long)blockIdx.x * (WX_PRE_THREADS / 32) + (threadIdx.x >> 5);
    const int ln = threadIdx.x & 31;
    if (row >= ny + nx) return;  // (a whole warp)
    const bool is_y = row < ny;
    if (!is_y) row -= ny;
    const int npad = is_y ? sc.k_pad : sc.m_pad;
    const int n = is_y ? k : m;
    const int l = (int)(row / npad);
    const int r = (int)(row - (long long)l * npad);
    float* dst = reinterpret_cast<float*>(scratch + (is_y ? sc.y2 : sc.x2)) + row;
    if (r >= n) {
      if (ln == 0) *dst = is_y ? 0.f : INFINITY;
      return;
    }
    const float* src = (is_y ? y : x) + ((long long)l * n + r) * d;
    float s2 = 0.f;  // a lane's chain over features ln, ln + 32, ..., then a fixed tree
    for (int f = ln; f < d; f += 32) s2 = fmaf(src[f], src[f], s2);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    if (ln == 0) *dst = s2;
    return;
  }
  const int ws = sc.sl.ws, C = sc.sl.c, q8 = ws / 8;
  const long long ry = (long long)C * ny * q8;  // chunks of each plane
  const long long rx = (long long)C * nx * q8;
  const long long total = ry + rx + (long long)C * S * sc.m_pad * q8;
  for (long long e = (long long)(blockIdx.x - nn) * WX_PRE_THREADS + threadIdx.x; e < total;
       e += (long long)(gridDim.x - nn) * WX_PRE_THREADS) {
    long long f = e;  // the chunk's place in its plane
    const float* src;
    long long hi, lo, per;
    int n, npad, R;
    const bool is_xs = e >= ry + rx;
    if (e < ry) {
      src = y, n = k, npad = sc.k_pad, hi = sc.yh, lo = sc.yl, per = ny, R = sc.sl.rows;
    } else if (!is_xs) {
      f -= ry;
      src = x, n = m, npad = sc.m_pad, hi = sc.xh, lo = sc.xl, per = nx, R = WX_COLS;
    } else {
      f -= ry + rx;
      src = s, n = m, npad = sc.m_pad, hi = sc.xsh, lo = sc.xsl, per = (long long)S * sc.m_pad,
      R = WX_COLS;
    }
    // tile, then its column q of 8 features, then the row in the tile
    const long long tile = f / ((long long)R * q8);
    const long long w = f - tile * R * q8;
    const int q = (int)(w / R);
    const long long row = tile * R + (w - (long long)q * R);
    const int c = (int)(row / per);  // the slice
    const long long lr = row - c * per;
    const int l = (int)(lr / npad);
    const int r = (int)(lr - (long long)l * npad);
    const int f0 = c * ws + 8 * q;
    const bool valid = r < n;
    const float* sr = src + ((long long)l * n + r) * d;
    const float* xr = x + ((long long)(x_lane_stride ? l : 0) * m + r) * d;
    uint32_t wh[4], wl[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int fa = f0 + 2 * t;
      float a = valid && fa < d ? sr[fa] : 0.f;
      float b = valid && fa + 1 < d ? sr[fa + 1] : 0.f;
      if (is_xs) {
        a = valid && fa < d ? drive_operand(a, xr[fa], c2) : 0.f;
        b = valid && fa + 1 < d ? drive_operand(b, xr[fa + 1], c2) : 0.f;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
      wh[t] = *reinterpret_cast<const uint32_t*>(&h);
      wl[t] = *reinterpret_cast<const uint32_t*>(&v);
    }
    *reinterpret_cast<uint4*>(scratch + hi + 16 * f) = make_uint4(wh[0], wh[1], wh[2], wh[3]);
    *reinterpret_cast<uint4*>(scratch + lo + 16 * f) = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  }
}

__device__ __forceinline__ unsigned wx_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wx_bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wx_smem(bar)), "r"(count)
               : "memory");
}
// One arrival.
__device__ __forceinline__ void wx_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(wx_smem(bar)) : "memory");
}
// One arrival that also expects `bytes` from the bulk copies or st.async
// stores below.
__device__ __forceinline__ void wx_bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wx_smem(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) global to this block's shared memory by the
// copy engine, counted on `bar`.
__device__ __forceinline__ void wx_bulk(void* dst, const void* src, unsigned bytes,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(wx_smem(dst)),
      "l"(src), "r"(bytes), "r"(wx_smem(bar))
      : "memory");
}
// Wait for the phase of parity `parity` of `bar` (the bytes counted on it,
// whichever block of the cluster stored them, then visible); a store that
// never lands faults the kernel after ~2^24 polls rather than hanging the
// card.
__device__ __forceinline__ void wx_bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (int poll = 0; poll < (1 << 24) && !done; ++poll)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(wx_smem(bar)), "r"(parity)
        : "memory");
  if (!done) __trap();
}

__device__ __forceinline__ unsigned wx_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void wx_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wx_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The consumer warpgroups' own barrier (the producer warp does not join).
__device__ __forceinline__ void wx_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WX_CTHREADS) : "memory");
}
// Store `v` at `p`'s counterpart in the shared memory of the cluster's block
// `rank`, counted (16 bytes) on the counterpart of `bar` there: the storing
// thread does not wait for it, the receiver waits on its mbarrier.
__device__ __forceinline__ void wx_st_async(float4* p, uint64_t* bar, unsigned rank,
                                            float4 v) {
  unsigned a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(wx_smem(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(wx_smem(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(b)
      : "memory");
}

// A wgmma matrix descriptor of the bf16 operand at `p` in shared memory, no
// swizzle: `lbo` and `sbo` the byte strides between its 8 × 8 core matrices
// (128 contiguous bytes each) along the two axes — for a K-major operand
// the next 8 of K and the next 8 rows; for an MN-major one the next 8 of K
// and the next 8 of N.
__device__ __forceinline__ uint64_t wx_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((wx_smem(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads of wgmma accumulators across a wait.
template <int N>
__device__ __forceinline__ void wx_pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64×32, f32) = A·Bᵀ (+ D where `acc`): A (64×16) and B (32×16) bf16 in
// shared memory, both K-major, by descriptor.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// D (64×16, f32) = A·Bᵀ (+ D where `acc`): A (64×16) and B (16×16) bf16 in
// shared memory, both K-major, by descriptor.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc)
      : "memory");
}

// D (64×128, f32) = A·B (+ D where `acc`): A (64×16) bf16 in registers (four
// a thread, mma.sync's m16n8k16 A layout in each warp's 16 rows), B (16×128)
// bf16 in shared memory, MN-major (transposed), by descriptor.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}

// D (64×160, f32) = A·B (+ D where `acc`): A (64×16) bf16 in registers (four
// a thread, mma.sync's m16n8k16 A layout in each warp's 16 rows), B (16×160)
// bf16 in shared memory, MN-major (transposed), by descriptor.
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc)
      : "memory");
}


// Two f32 values as a bf16 pair (hi split) and the pair of their residuals.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Strides of the descriptors, in bytes: a tile of R rows keeps each 8
// features of its rows as R contiguous 16-byte rows (one core matrix every
// 8 rows, 128 bytes on), the next 8 features 16·R bytes on.  The x and xs
// tiles are WX_COLS rows.
constexpr unsigned WX_CORE = 128;            // the next 8 rows
constexpr unsigned WX_XCOL = 16 * WX_COLS;   // the next 8 features of an x or xs tile

// Shared memory of a block of `rows` rows at slice width ws, in bytes: the
// y planes (hi, lo); `nbuf` buffers of a tile's x planes (hi, lo) and
// `nbuf` of its xs planes; `nbuf` of its ‖x‖²; two buffers of the slots of
// the slices' Gram partials (c·⌈U/c⌉ ≤ U + WX_MAX_SLICES float4s each, U
// float4 units a tile); two buffers of a tile's K (U float4s each); ‖y‖² of
// the rows; the mbarriers: full and empty for each x and each xs buffer,
// and one for each slots and each K buffer.
struct WxLayout {
  int plane, y_lo, x, xs, x2, slots, slot_bytes, k, y2, bars, total;
  __host__ __device__ WxLayout(int rows, int nbuf, int u, int ws) {
    plane = 2 * WX_COLS * ws;
    y_lo = 2 * rows * ws;
    x = 2 * y_lo;                  // buffer b: hi at x + 2·plane·b, lo a plane on
    xs = x + 2 * plane * nbuf;     // the same for xs
    x2 = xs + 2 * plane * nbuf;    // buffer b at x2 + 4·WX_COLS·b
    slots = x2 + 4 * WX_COLS * nbuf;
    slot_bytes = 16 * (u + WX_MAX_SLICES);  // buffer b at slots + slot_bytes·b
    k = slots + 2 * slot_bytes;             // buffer b at k + 16·u·b
    y2 = k + 2 * 16 * u;
    bars = y2 + 4 * rows;
    total = bars + 8 * (4 * nbuf + 4);
  }
};

// WS: the slice width; ROWS: output rows a block (64·WX_CONSUMERS: a
// warpgroup's 64 each; 64: shared, the warpgroups splitting the tile's
// columns in the Gram and the slice in the drive); NBUF: the ring's
// buffers of the x and of the xs tiles.
//
// The consumers' tiles are pipelined so that the cluster's exchange
// overlaps MMAs: iteration t forms tile t's Gram partial and pushes its
// units to their owners (st.async: the owner's mbarrier counts the bytes,
// the sender does not wait); starts the drive of tile t − 1 once all of
// that tile's K is in; then, once all the partials of its own units of
// tile t are in, takes their K and pushes it to every block, and only then
// waits for the drive.  No cluster barrier in the loop: a block waits only
// for the bytes it needs.  The slots and K are double-buffered (a block's
// peers may send tile t + 1's while it still reads tile t's; a tile t + 2
// waits on the K of tile t + 1, sent only after its owner read tile t, and
// the consumers' barrier after each Gram keeps a block's own warps within
// a tile of each other).
template <int WS, int ROWS, int NBUF>
__global__ void __launch_bounds__(WX_THREADS, 1)
phi_wide_d_bf16x3_partial(const unsigned char* __restrict__ scratch,
                          float* __restrict__ part, int S, int k, int m, int d,
                          int x_lane_stride, int chunk, float nsc) {
  constexpr bool RW = ROWS == 64 * WX_CONSUMERS;  // a warpgroup's own 64 rows
  constexpr int GN = RW ? WX_COLS : WX_COLS / WX_CONSUMERS;  // its Gram columns
  constexpr int DN = RW ? WS : WS / WX_CONSUMERS;            // its drive features
  constexpr int NG = GN / 8;          // a thread's Gram units (its n-tiles)
  constexpr int U = NG * WX_CTHREADS; // float4 units of a Gram tile
  constexpr int KD = WS / 16;         // the Gram's k-steps
  static_assert(RW || ROWS == 64, "64 rows a warpgroup, or 64 shared");
  static_assert((GN == 32 || GN == 16) && (DN == 128 || DN == 160),
                "the wgmma shapes below");
  static_assert(NBUF >= 1, "a ring of buffers");
  const WxScratch sc(S, k, m, d, x_lane_stride);
  const int C = sc.sl.c;
  const WxLayout L(ROWS, NBUF, U, WS);
  extern __shared__ uint4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);

  const int tid = threadIdx.x;
  const unsigned rank = wx_cluster_rank();  // this block's d-slice
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = (blockIdx.x / C) * ROWS;
  const int xl = x_lane_stride ? lane : 0;
  // tile-major rows: y (rank, lane, row), x (rank, xl, j), xs (rank, lane, j)
  const long long yrow = ((long long)rank * S + lane) * sc.k_pad + row0;
  const long long xrow = ((long long)rank * sc.sx + xl) * sc.m_pad;
  const long long xsrow = ((long long)rank * S + lane) * sc.m_pad;
  const long long x2row = (long long)xl * sc.m_pad;
  const int j0 = split * chunk;
  const int ntiles = (min(sc.m_pad, j0 + chunk) - j0) / WX_COLS;
  // The Gram tile is U float4 units, unit q·WX_CTHREADS + tid consumer
  // thread tid's n-tile q; the slices own ⌈U/C⌉ consecutive units each, sum
  // their units' C partials (pushed into their slots, slot r·per + e from
  // slice r) and push the K of their units to every slice.
  const int per = (U + C - 1) / C;
  const int own0 = rank * per;
  const int own_n = min(per, U - own0);

  uint64_t* full_x = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* full_xs = full_x + NBUF;
  uint64_t* empty_x = full_xs + NBUF;
  uint64_t* empty_xs = empty_x + NBUF;
  uint64_t* bar_p = empty_xs + NBUF;  // the slots' (partials in)
  uint64_t* bar_k = bar_p + 2;        // K's (all of a tile's K in)
  if (tid == 0) {
    for (int i = 0; i < NBUF; ++i) {
      wx_bar_init(full_x + i, 1);
      wx_bar_init(full_xs + i, 1);
      wx_bar_init(empty_x + i, WX_CTHREADS / 32);
      wx_bar_init(empty_xs + i, WX_CTHREADS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      wx_bar_init(bar_p + i, 1);
      wx_bar_init(bar_k + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float* y2 = reinterpret_cast<const float*>(scratch + sc.y2) +
                    (long long)lane * sc.k_pad + row0;
  float* sy2 = reinterpret_cast<float*>(sm + L.y2);
  for (int r = tid; r < ROWS; r += WX_THREADS) sy2[r] = y2[r];
  wx_cluster_arrive();
  wx_cluster_wait();  // every block of the cluster is running (mbarriers, sy2 in place)

  const unsigned plane = L.plane;
  constexpr unsigned ybytes = 2 * ROWS * WS;
  if (tid >= WX_CTHREADS) {
    // the producer: x tile t (and ‖x‖²; with y at t = 0), then xs tile t,
    // each once the consumers have freed its buffer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WX_PRODUCER_REGS));
    if (tid == WX_CTHREADS) {
      for (int t = 0; t < ntiles; ++t) {
        const int b = t % NBUF;
        const long long j = j0 + (long long)t * WX_COLS;
        if (t >= NBUF) wx_bar_wait(empty_x + b, (t / NBUF - 1) & 1);
        unsigned char* xb = sm + L.x + 2 * plane * b;
        wx_bar_expect(full_x + b, 2 * plane + 4 * WX_COLS + (t == 0 ? 2 * ybytes : 0));
        if (t == 0) {
          wx_bulk(sm, scratch + sc.yh + 2 * yrow * WS, ybytes, full_x);
          wx_bulk(sm + L.y_lo, scratch + sc.yl + 2 * yrow * WS, ybytes, full_x);
        }
        wx_bulk(xb, scratch + sc.xh + 2 * (xrow + j) * WS, plane, full_x + b);
        wx_bulk(xb + plane, scratch + sc.xl + 2 * (xrow + j) * WS, plane, full_x + b);
        wx_bulk(sm + L.x2 + 4 * WX_COLS * b, scratch + sc.x2 + 4 * (x2row + j), 4 * WX_COLS,
                full_x + b);
        if (t >= NBUF) wx_bar_wait(empty_xs + b, (t / NBUF - 1) & 1);
        unsigned char* xsb = sm + L.xs + 2 * plane * b;
        wx_bar_expect(full_xs + b, 2 * plane);
        wx_bulk(xsb, scratch + sc.xsh + 2 * (xsrow + j) * WS, plane, full_xs + b);
        wx_bulk(xsb + plane, scratch + sc.xsl + 2 * (xsrow + j) * WS, plane, full_xs + b);
      }
    }
    // every block has received all its bytes; none leaves while a peer may
    // still be sending to it
    wx_cluster_arrive();
    wx_cluster_wait();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WX_CONSUMER_REGS));
  const int wg = tid >> 7;          // the warpgroup
  const int wid = (tid >> 5) & 3;   // the warp in it: rows 16·wid onwards
  const int ln = tid & 31;
  const int g = ln >> 2, t4 = ln & 3;
  float ks[2] = {0.f, 0.f};  // row-sums of rows g and g + 8
  float acc[DN / 2];         // the drive's accumulators
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  const int rb = RW ? 64 * wg : 0;  // the warpgroup's first row, Gram column,
  const int cb = RW ? 0 : GN * wg;  // drive feature
  const int fb = RW ? 0 : DN * wg;
  float pg[2][GN / 2];  // the Gram's fresh per-k-step partials, two in flight
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) pg[0][i] = pg[1][i] = 0.f;

  for (int t = 0; t <= ntiles; ++t) {
    float gs[GN / 2];
    if (t < ntiles) {
      if (tid == 0) {  // the bytes this block receives for tile t
        wx_bar_expect(bar_p + t % 2, 16u * C * own_n);
        wx_bar_expect(bar_k + t % 2, 16u * U);
      }
      // the warpgroup's Gram partial over this slice: its rows × its
      // columns of tile t
      wx_bar_wait(full_x + t % NBUF, (t / NBUF) & 1);  // x tile t (and y) landed
      const unsigned char* xt = sm + L.x + 2 * plane * (t % NBUF);
#pragma unroll
      for (int i = 0; i < GN / 2; ++i) gs[i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int ya = 2 * kd * 16 * ROWS + 16 * rb;  // k-step kd of the rows
        const int xa = 2 * kd * WX_XCOL + 16 * cb;
        const uint64_t ah = wx_desc(sm + ya, 16 * ROWS, WX_CORE);
        const uint64_t al = wx_desc(sm + L.y_lo + ya, 16 * ROWS, WX_CORE);
        const uint64_t bh = wx_desc(xt + xa, WX_XCOL, WX_CORE);
        const uint64_t bl = wx_desc(xt + plane + xa, WX_XCOL, WX_CORE);
        wgmma_fence();
        if constexpr (GN == 32) {
          wgmma_ss_n32(pg[kd & 1], ah, bh, 0);
          wgmma_ss_n32(pg[kd & 1], ah, bl, 1);
          wgmma_ss_n32(pg[kd & 1], al, bh, 1);
        } else {
          wgmma_ss_n16(pg[kd & 1], ah, bh, 0);
          wgmma_ss_n16(pg[kd & 1], ah, bl, 1);
          wgmma_ss_n16(pg[kd & 1], al, bh, 1);
        }
        wgmma_commit();
        if (kd > 0) {  // k-step kd − 1's partial is done: add it
          wgmma_wait<1>();
          wx_pin(pg[(kd - 1) & 1]);
#pragma unroll
          for (int i = 0; i < GN / 2; ++i) gs[i] += pg[(kd - 1) & 1][i];
        }
      }
      wgmma_wait<0>();
      wx_pin(pg[(KD - 1) & 1]);
#pragma unroll
      for (int i = 0; i < GN / 2; ++i) gs[i] += pg[(KD - 1) & 1][i];
    }
    // every consumer is past tile t − 1's drive reads of K
    wx_consumers_sync();
    if (t < ntiles) {
      // push each unit to the slice that owns it
      float4* slots = reinterpret_cast<float4*>(sm + L.slots + L.slot_bytes * (t % 2));
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const int u = q * WX_CTHREADS + tid;
        const int o = u / per;
        wx_st_async(slots + rank * per + (u - o * per), bar_p + t % 2, o,
                    make_float4(gs[4 * q], gs[4 * q + 1], gs[4 * q + 2], gs[4 * q + 3]));
      }
    }
    if (t > 0) {
      // the drive of tile t − 1: the K of this thread's rows over the
      // tile's four n-tiles (its own units, or its and its partner
      // warpgroup's) — row-sums, then hi/lo as the A fragments (k-step kk
      // is n-tiles 2kk, 2kk + 1) — times the xs tile (32 × the
      // warpgroup's DN features)
      wx_bar_wait(bar_k + (t - 1) % 2, ((t - 1) / 2) & 1);  // tile t − 1's K is in
      const float4* sk = reinterpret_cast<const float4*>(sm + L.k + 16 * U * ((t - 1) % 2));
      uint32_t khi[2][4], klo[2][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int src = RW ? tid : (tid & 127) + 128 * (c / NG);
        const float4 kv = sk[(c % NG) * WX_CTHREADS + src];
        ks[0] += kv.x;
        ks[0] += kv.y;
        ks[1] += kv.z;
        ks[1] += kv.w;
        split_pair(kv.x, kv.y, khi[c / 2][2 * (c % 2)], klo[c / 2][2 * (c % 2)]);
        split_pair(kv.z, kv.w, khi[c / 2][2 * (c % 2) + 1], klo[c / 2][2 * (c % 2) + 1]);
      }
      wx_bar_wait(full_xs + (t - 1) % NBUF, ((t - 1) / NBUF) & 1);  // xs tile t − 1 landed
      const unsigned char* xst = sm + L.xs + 2 * plane * ((t - 1) % NBUF);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int xa = (fb / 8) * WX_XCOL + 16 * 16 * kk;  // rows 16kk.. of the tile
        const uint64_t bh = wx_desc(xst + xa, WX_CORE, WX_XCOL);
        const uint64_t bl = wx_desc(xst + plane + xa, WX_CORE, WX_XCOL);
        if constexpr (DN == 128) {
          wgmma_rs_n128(acc, khi[kk], bh, 1);
          wgmma_rs_n128(acc, khi[kk], bl, 1);
          wgmma_rs_n128(acc, klo[kk], bh, 1);
        } else {
          wgmma_rs_n160(acc, khi[kk], bh, 1);
          wgmma_rs_n160(acc, khi[kk], bl, 1);
          wgmma_rs_n160(acc, klo[kk], bh, 1);
        }
      }
      wgmma_commit();
    }
    if (t < ntiles) {
      // K of the owned units: the C partials summed in slice order, then
      // (y² + x²) − 2·yx (the plain version's order; 2·yx is exact), clamp,
      // one exp; pushed to every slice
      wx_bar_wait(bar_p + t % 2, (t / 2) & 1);  // every slice's partials are in
      const float4* slots =
          reinterpret_cast<const float4*>(sm + L.slots + L.slot_bytes * (t % 2));
      const float* sx2 = reinterpret_cast<const float*>(sm + L.x2 + 4 * WX_COLS * (t % NBUF));
      float4* skt = reinterpret_cast<float4*>(sm + L.k + 16 * U * (t % 2));
      for (int e = tid; e < own_n; e += WX_CTHREADS) {
        float4 gv = slots[e];
        for (int c = 1; c < C; ++c) {
          const float4 pv = slots[c * per + e];
          gv.x += pv.x;
          gv.y += pv.y;
          gv.z += pv.z;
          gv.w += pv.w;
        }
        const int u = own0 + e;
        const int q = u / WX_CTHREADS;
        const int src = u - q * WX_CTHREADS;
        // n-tile q of consumer thread src: rows r and r + 8, columns j
        // and j + 1
        const int sln = src & 31;
        const int r = (RW ? 64 * (src >> 7) : 0) + 16 * ((src >> 5) & 3) + (sln >> 2);
        const int j = (RW ? 0 : GN * (src >> 7)) + 8 * q + 2 * (sln & 3);
        const float2 x2v = *reinterpret_cast<const float2*>(sx2 + j);
        const float ya2 = sy2[r], yb2 = sy2[r + 8];
        const float4 kv = make_float4(
            ot_ex2(fmaxf(fmaf(-2.f, gv.x, __fadd_rn(ya2, x2v.x)), 0.f) * nsc),
            ot_ex2(fmaxf(fmaf(-2.f, gv.y, __fadd_rn(ya2, x2v.y)), 0.f) * nsc),
            ot_ex2(fmaxf(fmaf(-2.f, gv.z, __fadd_rn(yb2, x2v.x)), 0.f) * nsc),
            ot_ex2(fmaxf(fmaf(-2.f, gv.w, __fadd_rn(yb2, x2v.y)), 0.f) * nsc));
        for (int c = 0; c < C; ++c) wx_st_async(skt + u, bar_k + t % 2, c, kv);
      }
      __syncwarp();
      if (ln == 0) wx_bar_arrive(empty_x + t % NBUF);  // x tile t and its ‖x‖² are free
    }
    // the drive of tile t − 1 is done (a wait on every path, so that ptxas
    // sees no read of its accumulators while it may be in flight)
    wgmma_wait<0>();
    wx_pin(acc);
    if (t > 0) {
      __syncwarp();
      if (ln == 0) wx_bar_arrive(empty_xs + (t - 1) % NBUF);  // xs tile t − 1 is free
    }
  }
  wx_cluster_arrive();
  wx_cluster_wait();

  // the four threads of a row group hold disjoint columns: combine the
  // row-sums in a fixed order; the first slice writes them (one warpgroup
  // where they share rows)
  const int f0 = rank * WS + fb;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ks[h] += __shfl_xor_sync(0xffffffffu, ks[h], 1);
    ks[h] += __shfl_xor_sync(0xffffffffu, ks[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + rb + 16 * wid + g + 8 * h;
    if (i >= k) continue;
    float* pr = part + (((long long)split * S + lane) * k + i) * (d + 1);
#pragma unroll
    for (int q = 0; q < DN / 8; ++q) {
      const int c = f0 + q * 8 + 2 * t4;
      if (c < d) pr[c] = acc[4 * q + 2 * h];
      if (c + 1 < d) pr[c + 1] = acc[4 * q + 2 * h + 1];
    }
    if (rank == 0 && (RW || wg == 0) && t4 == 0) pr[d] = ks[h];
  }
}

template <int WS, int ROWS, int NBUF>
static cudaError_t launch_partial(const unsigned char* scratch, float* part, int S, int k,
                                  int m, int d, int x_lane_stride, int chunk, int nsplit,
                                  float nsc, cudaStream_t stream) {
  constexpr int U = (ROWS == 64 * WX_CONSUMERS ? WX_COLS : WX_COLS / WX_CONSUMERS) / 8 *
                    WX_CTHREADS;
  auto kernel = phi_wide_d_bf16x3_partial<WS, ROWS, NBUF>;
  const int smem = WxLayout(ROWS, NBUF, U, WS).total;
  static bool ready[64] = {};  // the attribute, set once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const WxSlices sl(d);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((k + ROWS - 1) / ROWS * sl.c), (unsigned)S, (unsigned)nsplit);
  cfg.blockDim = dim3(WX_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)sl.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, scratch, part, S, k, m, d, x_lane_stride, chunk, nsc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bytes of scratch the launch below needs (ops/cuda_svgd.py computes the
// same from the WX_* constants for the tests; its wrapper sizes the buffer
// by this function).
extern "C" long long phi_wide_d_bf16x3_scratch_bytes(int S, int k, int m, int d,
                                                     int x_lane_stride) {
  return WxScratch(S, k, m, d, x_lane_stride).total;
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// s (S, m, d) the scores; scratch phi_wide_d_bf16x3_scratch_bytes() bytes,
// 16-byte aligned; part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All
// f32, contiguous, on `device`; 1 ≤ d ≤ 2432 (the wrapper routes 128 < d
// here); chunk a multiple of WX_COLS.  Launches the pre-pass, the partial
// sums (in clusters of the d-slices) and the finalize on `stream`,
// allocates nothing, does not synchronise; returns the cudaGetLastError()
// code.
extern "C" int phi_wide_d_bf16x3_launch(const void* y, const void* x, const void* s,
                                        void* scratch, void* part, void* out, int S,
                                        int k, int m, int d, int x_lane_stride, int chunk,
                                        int nsplit, float inv_h, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > WX_MAX_D || chunk % WX_COLS) return (int)cudaErrorInvalidValue;
  unsigned char* bscratch = static_cast<unsigned char*>(scratch);
  float* fpart = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WxScratch sc(S, k, m, d, x_lane_stride);
  const long long rows = (long long)S * sc.k_pad + (long long)sc.sx * sc.m_pad;
  const int nn = (int)((rows + WX_PRE_THREADS / 32 - 1) / (WX_PRE_THREADS / 32));
  const long long chunks = (long long)sc.sl.c * (rows + (long long)S * sc.m_pad) *
                           (sc.sl.ws / 8);
  const long long want = (chunks + WX_PRE_THREADS - 1) / WX_PRE_THREADS;
  phi_wide_d_bf16x3_prepass<<<nn + (unsigned)(want < 8192 ? want : 8192), WX_PRE_THREADS,
                              0, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<const float*>(s), bscratch, S, k, m, d, x_lane_stride, nn,
      2.0f * inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float nsc = -OT_LOG2E * inv_h;
  err = d <= WX_NARROW_MAX_D
            ? launch_partial<WX_SLICE, WX_ROWS, WX_BUFFERS>(bscratch, fpart, S, k, m, d,
                                                             x_lane_stride, chunk, nsplit,
                                                             nsc, st)
            : launch_partial<WX_WIDE_SLICE, WX_WIDE_ROWS, WX_WIDE_BUFFERS>(
                  bscratch, fpart, S, k, m, d, x_lane_stride, chunk, nsplit, nsc, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_phi_finalize(fpart, static_cast<const float*>(y),
                                  static_cast<float*>(out), nsplit, S, k, d, m, inv_h,
                                  st);
}
