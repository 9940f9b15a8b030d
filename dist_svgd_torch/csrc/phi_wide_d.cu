// Fused SVGD φ for feature dims 128 < d ≤ 2432, exact f32 tier — hand-written
// for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel` (reached through
// `phi_pallas`) in its exact tier (Precision.HIGHEST) beyond the d ≤ 128 of
// phi_big_d.cu, up to the d = 2432 that `fits_vmem_big_d` admits, together
// with its `_phi_tail` epilogue.  The path that runs it is the Bayesian
// neural network of BASELINE.json config 5 (a particle is the flat weight
// vector, d = 753 on boston).
//
// Computes, for every lane l of S and output row i of k:
//
//     d²_ij  = max(‖y_i‖² + ‖x_j‖² − 2·y_i·x_j, 0)        (the MXU form)
//     K_ij   = exp(−d²_ij / h)
//     φ(y_i) = (Σ_j K_ij · xs_j + (2/h) · y_i · Σ_j K_ij) / m,
//     xs     = s − (2/h)·x     (formed once a call by the pre-pass, rounded
//                               as the plain version's torch ops round it)
//
// What bounds it on this card: FP32 issue, and the shared memory that feeds
// it.  A call is two length-d products a pair (the Gram y·xᵀ and the drive
// K·xs), 2d FFMAs: 3.8e8 at the BNN's one lane (500 × 500, d = 753), 1.5e11
// at 8 lanes × 1250 × 10,000, on a few to a few hundred MB.  The tier's
// contract is f32, so the floor is the CUDA cores' FFMA rate: each FFMA must
// cost about one issue slot, fed by 128-bit shared loads.
//
// What the design does about it — phi_big_d.cu's register-tiled GEMMs, with
// the feature axis split across the blocks of a thread-block cluster:
// - a row's drive is d floats, too many for one thread block's registers at
//   d = 753 (and the full-width tiles too many for its shared memory), so d
//   is cut into C ≤ 8 slices of ws = WD_SLICE (WD_WIDE_SLICE beyond
//   WD_NARROW_MAX_D) features, one a block, and the C blocks of a row block
//   form a cluster (one block an SM: C SMs share the work of a row block);
//   a slice's width is a compile-time constant, so every loop over it is
//   unrolled with no bounds of its own (the last slice is padded with zeros);
// - a pre-pass (phi_wide_d_prepass, same launch) writes y, x and xs (from s
//   and x) into wrapper-allocated scratch slice by slice — a block's tiles
//   are contiguous rows of ls = ws + 4 floats (ls/4 odd, so eight
//   consecutive rows of float4s hit eight distinct bank groups), row counts
//   padded to whole tiles — and each padded row's norm over each slice (y
//   and x staged through shared memory WD_PRE_ROWS rows at a time, so the
//   loads of a row are coalesced);
// - each block forms its slice's partial Gram tile as phi_big_d.cu does
//   (TR × 8 register tiles a thread, 8 × 8 up to WD_NARROW_MAX_D: one fmaf
//   a feature in order, 16 128-bit loads for 256 FFMAs), its two halves of
//   threads taking the two
//   halves of the slice, summed through shared memory (first half first); the
//   tile's float4 units are dealt out to the slices, and each block pushes
//   every unit of its partial into the shared memory of the unit's owner
//   (distributed shared memory, st.async: the owner's mbarrier counts the
//   bytes, the sender never waits, and a block receives one tile, not C);
//   once they are in, each owner sums its units' C partials in slice order
//   (no float atomics), takes their K and pushes it to every block the same
//   way — no cluster barrier in the loop;
// - the norms are the same half-slice FMA chains summed in the same order,
//   so a pair whose y_i and x_j are the same bits (the BNN Sampler's
//   y = x at h = 1) gets d² = 0 exactly, as in f64; a padding column's norm
//   is +inf, so its K is exactly 0 and the loops need no masks;
// - K is the clamp and one ex2.approx a pair (the bandwidth folded into one
//   scale); once all of it is in, every block holds the tile's K as
//   float4s and runs the drive of its own slice, a TR × WD_TD register
//   tile a thread fed by 128-bit loads of K and xs; the drive's
//   accumulators stay in registers for the whole m range;
// - the x and xs tiles are copied with cp.async into single buffers that
//   alternate with the phases, as in phi_big_d.cu (a pipeline that runs the
//   next tile's Gram during the exchange, as phi_wide_d_bf16x3.cu does,
//   measured 3% slower here, with cluster barriers: the exchange is a
//   ninth of a tile's time);
// - the m axis is split across `nsplit` clusters per row block (the
//   wrapper's split at WD_BLOCKS_PER_SM, counting every block of a
//   cluster) and phi_finalize (phi_common.cuh) reduces the partials in a
//   fixed order — deterministic, no float atomics.
#include <cuda_runtime.h>
#include <math.h>

#include "ot_common.cuh"  // ot_ex2, OT_LOG2E
#include "phi_common.cuh"

constexpr int WD_COLS = 64;  // interaction rows per shared-memory tile
constexpr int WD_TD = 8;     // d is padded to a multiple of this: the drive tile
// Up to d = WD_NARROW_MAX_D: WD_ROWS output rows a block of WD_THREADS, d-slices
// of at most WD_SLICE features; beyond, WD_WIDE_ROWS rows a block of
// WD_WIDE_THREADS and slices of at most WD_WIDE_SLICE (so that d = 2432 takes
// WD_MAX_SLICES blocks a cluster).  Wider slices do not fit 128 rows' tiles
// in shared memory; at d = 753, slices of 192 and 256 at 32 rows (clusters
// of 4 and 3) measured 1.12× and 1.03× slower at 8 × 1250 × 10,000 and
// 1.25× at the BNN's lane, 1.4× faster at its 8-shard lanes of 62 rows
// (tools/ot_ab.py on an H100).
constexpr int WD_ROWS = 128;
constexpr int WD_THREADS = 256;
constexpr int WD_SLICE = 128;
constexpr int WD_WIDE_ROWS = 32;
constexpr int WD_WIDE_THREADS = 128;
constexpr int WD_WIDE_SLICE = 320;
constexpr int WD_NARROW_MAX_D = 1024;
constexpr int WD_MAX_SLICES = 8;  // blocks a cluster: the portable maximum
// The m-split's target of blocks an SM that the wrapper gives this kernel
// (ops/cuda_svgd.py:_KERNELS; the kernel takes the split as `chunk`,
// `nsplit`), counting every block of a cluster; one block fits an SM (and
// 17 clusters of six, the card holds at d = 753).  Of 1, 2 and 4 measured
// on an H100 (tools/ot_ab.py), all alike at 8 × 1250 × 10,000; 1 the
// fastest at the BNN's 1 × 500 × 500 lane (one wave of two tiles a block,
// not two waves of one), 2 at its 8-shard lanes.
constexpr int WD_BLOCKS_PER_SM = 1;
constexpr int WD_MAX_D = 2432;  // fits_vmem_big_d's largest d
constexpr int WD_PRE_THREADS = 256;
constexpr int WD_PRE_ROWS = 32;  // padded rows of one slice a pre-pass block stages
constexpr int WD_KL4 = WD_COLS / 4 + 1;  // float4s a K row (odd)

static_assert(WD_ROWS % WD_PRE_ROWS == 0 && WD_WIDE_ROWS % WD_PRE_ROWS == 0 &&
                  WD_COLS % WD_PRE_ROWS == 0 &&
                  WD_SLICE <= WD_WIDE_SLICE,
              "the pre-pass's blocks of rows tile the padded rows");
static_assert(WD_SLICE % (2 * 4) == 0 && WD_WIDE_SLICE % (2 * 4) == 0 &&
                  WD_SLICE % WD_TD == 0 && WD_WIDE_SLICE % WD_TD == 0,
              "ws/4 even (so ls/4 is odd), whole drive tiles");

// The d-slices: d cut into c slices of ws features (the last padded with
// zeros), each stored in rows of ls floats.
struct WdSlices {
  int c, ws, ls, rows;
  __host__ __device__ explicit WdSlices(int d) {
    const bool narrow = d <= WD_NARROW_MAX_D;
    ws = narrow ? WD_SLICE : WD_WIDE_SLICE;
    c = (d + ws - 1) / ws;
    ls = ws + 4;
    rows = narrow ? WD_ROWS : WD_WIDE_ROWS;
  }
};

struct WdScratch {  // offsets in floats, every region 16-byte aligned
  long long yp, xp, xsp, y2p, x2p, total;
  int k_pad, m_pad, sx;
  WdSlices sl;
  __host__ __device__ WdScratch(int S, int k, int m, int d, int x_lane_stride) : sl(d) {
    k_pad = (k + sl.rows - 1) / sl.rows * sl.rows;
    m_pad = (m + WD_COLS - 1) / WD_COLS * WD_COLS;
    sx = x_lane_stride ? S : 1;
    // slice-major: (slice, lane, row, ls) planes of y, x and xs, then the
    // (slice, lane, row) partial norms of y and x
    yp = 0;
    xp = yp + (long long)sl.c * S * k_pad * sl.ls;
    xsp = xp + (long long)sl.c * sx * m_pad * sl.ls;
    y2p = xsp + (long long)sl.c * S * m_pad * sl.ls;
    x2p = y2p + (long long)sl.c * S * k_pad;
    total = x2p + (long long)sl.c * sx * m_pad;
  }
};

// xs = s − (2/h)·x as the wrapper's torch ops round it: (2/h)·x, then the
// difference (c2 = 2·inv_h in f32 is torch's f32 scalar 2/h: a power of two
// times the same rounding).
__device__ __forceinline__ float drive_operand(float s, float x, float c2) {
  return __fsub_rn(s, __fmul_rn(c2, x));
}

// Blocks [0, ny) pad the y rows' slices and take their partial norms,
// WD_PRE_ROWS rows of one slice a block; [ny, ny + nx) the x rows'; the rest
// form xs from s and x, one thread a float4.
static __global__ void __launch_bounds__(WD_PRE_THREADS)
phi_wide_d_prepass(const float* __restrict__ y, const float* __restrict__ x,
                   const float* __restrict__ s, float* __restrict__ scratch, int S,
                   int k, int m, int d, int x_lane_stride, int ny, int nx, float c2) {
  const WdScratch sc(S, k, m, d, x_lane_stride);
  const int L4 = sc.sl.ls / 4;
  const int b = blockIdx.x;
  if (b < ny + nx) {
    // WD_PRE_ROWS padded rows of one slice of y or x, staged through
    // shared memory so that the loads are coalesced
    __shared__ float tile[WD_PRE_ROWS][WD_WIDE_SLICE + 1];
    __shared__ float halves[WD_PRE_ROWS][2];
    __shared__ long long from[WD_PRE_ROWS];  // a row's first element in y or x; −1: padding
    const bool is_y = b < ny;
    const int npad = is_y ? sc.k_pad : sc.m_pad;
    const int n = is_y ? k : m;
    const long long per_slice = (long long)(is_y ? S : sc.sx) * npad;
    const long long blocks = per_slice / WD_PRE_ROWS;  // a slice's
    const long long bb = is_y ? b : b - ny;
    const int c = (int)(bb / blocks);
    const long long row0 = (bb - c * blocks) * WD_PRE_ROWS;  // (lane, row) in the slice
    const int ws = sc.sl.ws;
    const int f0 = c * ws;  // the slice's first feature
    const float* src = is_y ? y : x;
    if (threadIdx.x < WD_PRE_ROWS) {
      const long long row = row0 + threadIdx.x;
      const int l = (int)(row / npad);
      const int r = (int)(row - (long long)l * npad);
      from[threadIdx.x] = r < n ? ((long long)l * n + r) * d + f0 : -1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < WD_PRE_ROWS * ws; e += WD_PRE_THREADS) {
      const int rr = e / ws;
      const int f = e - rr * ws;
      const long long at = from[rr];
      tile[rr][f] = at >= 0 && f0 + f < d ? src[at + f] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < 2 * WD_PRE_ROWS) {
      // the Gram's chain over one half of the slice: one fmaf a feature, in
      // order
      const int rr = threadIdx.x >> 1;
      const int hv = threadIdx.x & 1;
      float s2 = 0.f;
      for (int f = hv * ws / 2; f < (hv + 1) * ws / 2; ++f) s2 = fmaf(tile[rr][f], tile[rr][f], s2);
      halves[rr][hv] = s2;
    }
    float4* dst = reinterpret_cast<float4*>(scratch + (is_y ? sc.yp : sc.xp)) +
                  (c * per_slice + row0) * L4;
    for (int e = threadIdx.x; e < WD_PRE_ROWS * L4; e += WD_PRE_THREADS) {
      const int rr = e / L4;
      const int f = 4 * (e - rr * L4);
      dst[e] = f < ws ? make_float4(tile[rr][f], tile[rr][f + 1], tile[rr][f + 2], tile[rr][f + 3])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (threadIdx.x < WD_PRE_ROWS)  // the halves' sum, the first half's first
      scratch[(is_y ? sc.y2p : sc.x2p) + c * per_slice + row0 + threadIdx.x] =
          from[threadIdx.x] >= 0 ? halves[threadIdx.x][0] + halves[threadIdx.x][1]
                                 : (is_y ? 0.f : INFINITY);
    return;
  }
  const long long rows = (long long)S * sc.m_pad;  // xs rows a slice
  const long long total = sc.sl.c * rows * L4;
  float4* dst = reinterpret_cast<float4*>(scratch + sc.xsp);
  for (long long e = (long long)(b - ny - nx) * WD_PRE_THREADS + threadIdx.x; e < total;
       e += (long long)(gridDim.x - ny - nx) * WD_PRE_THREADS) {
    const long long row = e / L4;
    const int q = (int)(e - row * L4);
    const int c = (int)(row / rows);
    const long long lr = row - c * rows;
    const int l = (int)(lr / sc.m_pad);
    const int r = (int)(lr - (long long)l * sc.m_pad);
    const int f = c * sc.sl.ws + 4 * q;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < m && 4 * q < sc.sl.ws) {
      const float* sr = s + ((long long)l * m + r) * d;
      const float* xr = x + ((long long)(x_lane_stride ? l : 0) * m + r) * d;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = f + t < d ? drive_operand(sr[f + t], xr[f + t], c2) : 0.f;
    }
    dst[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void wd_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void wd_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wd_cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// `n4` contiguous float4s, global to shared, spread over the block.
template <int THREADS>
__device__ __forceinline__ void wd_copy(float4* dst, const float* src, int n4) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e = threadIdx.x; e < n4; e += THREADS) wd_cp_async16(dst + e, s4 + e);
}

__device__ __forceinline__ unsigned wd_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void wd_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wd_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned wd_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// Store `v` at `p`'s counterpart in the shared memory of the cluster's block
// `rank`, counted (16 bytes) on the counterpart of `bar` there: the storing
// thread does not wait for it, the receiver waits on its mbarrier.
__device__ __forceinline__ void wd_st_async(float4* p, unsigned long long* bar,
                                            unsigned rank, float4 v) {
  unsigned a, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(wd_smem(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(b) : "r"(wd_smem(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(b)
      : "memory");
}
__device__ __forceinline__ void wd_bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wd_smem(bar)) : "memory");
}
// One arrival that also expects `bytes` stored by the cluster's blocks.
__device__ __forceinline__ void wd_bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(wd_smem(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` of `bar` (the peers' stores then
// visible); a store that never lands faults the kernel after ~2^24 polls
// rather than hanging the card.
__device__ __forceinline__ void wd_bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (int poll = 0; poll < (1 << 24) && !done; ++poll)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(wd_smem(bar)), "r"(parity)
        : "memory");
  if (!done) __trap();
}

// THREADS threads own ROWS output rows; a thread's tiles are TR rows × TC
// columns of the Gram over one half of the slice's W features (the two
// halves of the block take the two halves of the slice), and TR rows ×
// WD_TD features of the drive.
template <int THREADS, int ROWS, int TR, int TC, int W>
struct WdGeo {
  static constexpr int RG = ROWS / TR;      // row groups
  static constexpr int CG = WD_COLS / TC;   // column groups of the Gram
  static constexpr int C4 = TC / 4;         // float4s of a thread's K row
  static constexpr int NT2 = (RG * (W / WD_TD) + THREADS - 1) / THREADS;  // drive tiles
  static constexpr int HT = THREADS / 2;       // threads a half
  static constexpr int U = TR * C4 * HT;       // float4 units of a Gram tile
  static constexpr int L4 = (W + 4) / 4;       // float4s a staged row
  static_assert(2 * RG * CG == THREADS, "the Gram maps one tile a thread of a half");
  static_assert(W % 8 == 0 && U <= WD_COLS * L4, "halves of whole float4s; the half-sum fits the x tile");
  static_assert(TC % 4 == 0 && WD_TD % 4 == 0, "tiles of whole float4s");
  static_assert(CG <= 32 && (CG & (CG - 1)) == 0, "a row group's lanes");
  static_assert(W % WD_TD == 0 && ROWS % 4 == 0, "whole tiles");
  static_assert(ROWS <= THREADS && WD_COLS <= THREADS, "a thread a norm, a row-sum");
  // shared memory: y, x, xs tiles, K, the slots of the slices' Gram
  // partials (c·⌈U/c⌉ ≤ U + WD_MAX_SLICES units), the partial norms and the
  // norms, two mbarriers
  static constexpr size_t SMEM =
      sizeof(float4) * ((size_t)(ROWS + 2 * WD_COLS) * L4 + (size_t)ROWS * WD_KL4 +
                        (size_t)U + WD_MAX_SLICES) +
      sizeof(float) * (WD_MAX_SLICES + 1) * (ROWS + WD_COLS) + 2 * 8;
};

template <int THREADS, int ROWS, int TR, int TC, int W>
__global__ void __launch_bounds__(THREADS, 1)
phi_wide_d_partial(const float* __restrict__ scratch, float* __restrict__ part, int S,
                   int k, int m, int d, int x_lane_stride, int chunk, float nsc) {
  using G = WdGeo<THREADS, ROWS, TR, TC, W>;
  constexpr int RG = G::RG, CG = G::CG, C4 = G::C4, NT2 = G::NT2, U = G::U, L4 = G::L4;
  constexpr int D4 = WD_TD / 4;   // float4s of a thread's drive row
  constexpr int ls = 4 * L4;
  constexpr int Q = W / 4;        // float4s of the slice the Gram runs over
  constexpr int Q2 = W / WD_TD;   // drive column groups
  const WdScratch sc(S, k, m, d, x_lane_stride);
  const int C = sc.sl.c;
  extern __shared__ float4 smem4[];
  float4* sy = smem4;                   // ROWS × L4
  float4* sx = sy + ROWS * L4;          // WD_COLS × L4
  float4* sxs = sx + WD_COLS * L4;      // WD_COLS × L4
  float4* sk = sxs + WD_COLS * L4;      // ROWS × WD_KL4
  float4* slots = sk + ROWS * WD_KL4;   // C × per: the Gram partials this block sums
  float* sy2 = reinterpret_cast<float*>(slots + U + WD_MAX_SLICES);  // C × ROWS
  float* sx2 = sy2 + WD_MAX_SLICES * ROWS;                           // C × WD_COLS
  float* sy2f = sx2 + WD_MAX_SLICES * WD_COLS;                       // ROWS norms
  float* sx2f = sy2f + ROWS;                                         // WD_COLS norms
  // a tile's partials of this block's units in; all of a tile's K in
  unsigned long long* bar_p = reinterpret_cast<unsigned long long*>(sx2f + WD_COLS);
  unsigned long long* bar_k = bar_p + 1;

  const int tid = threadIdx.x;
  const unsigned rank = wd_cluster_rank();  // this block's d-slice
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = (blockIdx.x / C) * ROWS;
  const int xl = x_lane_stride ? lane : 0;
  const float* ypl = scratch + sc.yp + (((long long)rank * S + lane) * sc.k_pad + row0) * ls;
  const float* xpl = scratch + sc.xp + ((long long)rank * sc.sx + xl) * sc.m_pad * ls;
  const float* xspl = scratch + sc.xsp + ((long long)rank * S + lane) * sc.m_pad * ls;
  const int j0 = split * chunk;
  const int j1 = min(sc.m_pad, j0 + chunk);
  // The Gram tile is U float4 units, unit q·THREADS + tid the float4 q of
  // thread tid's tile; the slices own ⌈U/C⌉ consecutive units each, sum
  // their units' C partials (pushed into their slots, slot r·per + e from
  // slice r) and push the K of their units to every slice.
  const int per = (U + C - 1) / C;
  const int own0 = rank * per;
  const int own_n = min(per, U - own0);
  // the partial norms of slice c: y rows, then the x rows of a tile from j
  auto y2_of = [&](int c) {
    return scratch + sc.y2p + ((long long)c * S + lane) * sc.k_pad + row0;
  };
  auto x2_of = [&](int c, int j) {
    return scratch + sc.x2p + ((long long)c * sc.sx + xl) * sc.m_pad + j;
  };

  wd_copy<THREADS>(sy, ypl, ROWS * L4);
  for (int c = 0; c < C; ++c)
    wd_copy<THREADS>(reinterpret_cast<float4*>(sy2 + c * ROWS), y2_of(c), ROWS / 4);
  wd_copy<THREADS>(sx, xpl + (long long)j0 * ls, WD_COLS * L4);
  for (int c = 0; c < C; ++c)
    wd_copy<THREADS>(reinterpret_cast<float4*>(sx2 + c * WD_COLS), x2_of(c, j0), WD_COLS / 4);
  wd_cp_commit();
  wd_copy<THREADS>(sxs, xspl + (long long)j0 * ls, WD_COLS * L4);
  wd_cp_commit();

  // the Gram: rows rg + RG·a, columns cg + CG·i of the slice's half hs; the
  // K of columns cg + CG·(4v + t), t < 4, is the float4 cg + CG·v of its row
  const int hs = tid / G::HT;
  const int rg = (tid % G::HT) / CG;
  const int cg = tid % CG;
  // the drive: tile u is rows rg2 + RG·a, the float4s cg2 + Q2·h of the slice
  int rg2[NT2], cg2[NT2];
  bool act[NT2];
#pragma unroll
  for (int u = 0; u < NT2; ++u) {
    const int t2 = tid + u * THREADS;
    rg2[u] = t2 / Q2;
    cg2[u] = t2 - rg2[u] * Q2;
    act[u] = rg2[u] < RG;
  }
  float4 acc[NT2][TR][D4];
#pragma unroll
  for (int u = 0; u < NT2; ++u)
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int h = 0; h < D4; ++h) acc[u][a][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  float ks = 0.f;  // the row-sum of row tid (tid < ROWS)
  if (tid == 0) {
    wd_bar_init(bar_p);
    wd_bar_init(bar_k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  wd_cluster_arrive();
  wd_cluster_wait();  // every block of the cluster is running, its mbarriers set

  for (int t0 = j0; t0 < j1; t0 += WD_COLS) {
    const bool more = t0 + WD_COLS < j1;
    const int t = (t0 - j0) / WD_COLS;  // the tile: one phase of each mbarrier
    wd_cp_wait1();  // all but the newest group (xs of this tile) landed
    __syncthreads();
    // the norms: the slices' partials in slice order
    if (t0 == j0 && tid < ROWS) {
      float v = sy2[tid];
      for (int c = 1; c < C; ++c) v += sy2[c * ROWS + tid];
      sy2f[tid] = v;
    }
    if (tid < WD_COLS) {
      float v = sx2[tid];
      for (int c = 1; c < C; ++c) v += sx2[c * WD_COLS + tid];
      sx2f[tid] = v;
    }
    if (tid == 0) {  // the bytes this block receives for the tile
      wd_bar_expect(bar_p, 16u * C * own_n);
      wd_bar_expect(bar_k, 16u * U);
    }
    // this half-slice's Gram partial, one fmaf a feature in order
    float dot[TR][TC];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int i = 0; i < TC; ++i) dot[a][i] = 0.f;
    const float4* ya = sy + rg * L4;
    const float4* xb = sx + cg * L4;
#pragma unroll 2
    for (int c4 = hs * Q / 2; c4 < (hs + 1) * Q / 2; ++c4) {
      float4 xv[TC];
#pragma unroll
      for (int i = 0; i < TC; ++i) xv[i] = xb[i * CG * L4 + c4];
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float4 yv = ya[a * RG * L4 + c4];
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          dot[a][i] = fmaf(yv.x, xv[i].x, dot[a][i]);
          dot[a][i] = fmaf(yv.y, xv[i].y, dot[a][i]);
          dot[a][i] = fmaf(yv.z, xv[i].z, dot[a][i]);
          dot[a][i] = fmaf(yv.w, xv[i].w, dot[a][i]);
        }
      }
    }
    // the two halves' chains summed (the first half's first), in the first
    // half's threads, through the x tile's buffer: every thread's Gram has
    // read it (the barrier below), and its next tile is copied in only once
    // all of this tile's K is in — after every owner has all of this
    // block's units, each pushed after the half-sum it holds was read
    __syncthreads();
    float4* hsum = sx + (tid % G::HT);
    if (hs == 1) {
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int v = 0; v < C4; ++v)
          hsum[(a * C4 + v) * G::HT] =
              make_float4(dot[a][4 * v], dot[a][4 * v + 1], dot[a][4 * v + 2], dot[a][4 * v + 3]);
    }
    __syncthreads();
    if (hs == 0) {
      // push each unit to the slice that owns it
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int v = 0; v < C4; ++v) {
          const float4 o4 = hsum[(a * C4 + v) * G::HT];
          const int u = (a * C4 + v) * G::HT + tid;
          const int o = u / per;
          wd_st_async(slots + rank * per + (u - o * per), bar_p, o,
                      make_float4(dot[a][4 * v] + o4.x, dot[a][4 * v + 1] + o4.y,
                                  dot[a][4 * v + 2] + o4.z, dot[a][4 * v + 3] + o4.w));
        }
    }
    // every slice's partials of this block's units are in (a peer sends the
    // next tile's only once it has this tile's K, sent after these are read)
    wd_bar_wait(bar_p, t & 1);
    // K of the owned units: the C partials summed in slice order, then
    // 2^(−max(y² + x² − 2·dot, 0)·log2(e)/h), pushed to every slice's K
    for (int e = tid; e < own_n; e += THREADS) {
      float4 dv = slots[e];
      for (int c = 1; c < C; ++c) {
        const float4 pv = slots[c * per + e];
        dv.x += pv.x;
        dv.y += pv.y;
        dv.z += pv.z;
        dv.w += pv.w;
      }
      const int u = own0 + e;
      const int q = u / G::HT;
      const int src = u - q * G::HT;
      const int a = q / C4;
      const int v = q - a * C4;
      const int row = src / CG + RG * a;
      const int cu = src % CG + CG * v;     // the float4's place in a K row
      const int j = src % CG + CG * 4 * v;  // its columns j + CG·t, t < 4
      const float y2v = sy2f[row];
      const float4 kv = make_float4(
          ot_ex2(fmaxf(fmaf(-2.f, dv.x, y2v + sx2f[j]), 0.f) * nsc),
          ot_ex2(fmaxf(fmaf(-2.f, dv.y, y2v + sx2f[j + CG]), 0.f) * nsc),
          ot_ex2(fmaxf(fmaf(-2.f, dv.z, y2v + sx2f[j + 2 * CG]), 0.f) * nsc),
          ot_ex2(fmaxf(fmaf(-2.f, dv.w, y2v + sx2f[j + 3 * CG]), 0.f) * nsc));
      for (int c = 0; c < C; ++c) wd_st_async(sk + row * WD_KL4 + cu, bar_k, c, kv);
    }
    // all of the tile's K is in (the next tile's comes only after this
    // block's partials of it, sent after its drive)
    wd_bar_wait(bar_k, t & 1);
    if (rank == 0 && tid < ROWS) {  // the row-sum, in a fixed order
      float v = 0.f;
#pragma unroll 4
      for (int q = 0; q < WD_COLS / 4; ++q) {
        const float4 kq = sk[tid * WD_KL4 + q];
        v += (kq.x + kq.y) + (kq.z + kq.w);
      }
      ks += v;
    }
    if (more) {
      wd_copy<THREADS>(sx, xpl + (long long)(t0 + WD_COLS) * ls, WD_COLS * L4);
      for (int c = 0; c < C; ++c)
        wd_copy<THREADS>(reinterpret_cast<float4*>(sx2 + c * WD_COLS),
                         x2_of(c, t0 + WD_COLS), WD_COLS / 4);
    }
    wd_cp_commit();
    wd_cp_wait1();  // xs of this tile landed
    __syncthreads();
    // the drive: the float4 q of a K row holds columns
    // q % CG + CG·(4·(q / CG) + t), t < 4
#pragma unroll
    for (int u = 0; u < NT2; ++u) {
      if (!act[u]) continue;
      const float4* kr = sk + rg2[u] * WD_KL4;
      const float4* xr = sxs + cg2[u];
#pragma unroll 2
      for (int q = 0; q < WD_COLS / 4; ++q) {
        const int jb = q % CG + CG * 4 * (q / CG);
        float4 xv[4][D4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int h = 0; h < D4; ++h) xv[t][h] = xr[(jb + CG * t) * L4 + Q2 * h];
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          const float4 kq = kr[a * RG * WD_KL4 + q];
          const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int h = 0; h < D4; ++h) {
              float4& o = acc[u][a][h];
              o.x = fmaf(kk[t], xv[t][h].x, o.x);
              o.y = fmaf(kk[t], xv[t][h].y, o.y);
              o.z = fmaf(kk[t], xv[t][h].z, o.z);
              o.w = fmaf(kk[t], xv[t][h].w, o.w);
            }
        }
      }
    }
    __syncthreads();  // K and xs are free
    if (more) wd_copy<THREADS>(sxs, xspl + (long long)(t0 + WD_COLS) * ls, WD_COLS * L4);
    wd_cp_commit();
  }
  // every block has received all its bytes; none leaves while a peer may
  // still be sending to it
  wd_cluster_arrive();
  wd_cluster_wait();
  // (the first slice holds the row-sums)
  float* pl = part + ((long long)split * S + lane) * k * (d + 1);
  if (rank == 0 && tid < ROWS && row0 + tid < k) pl[(long long)(row0 + tid) * (d + 1) + d] = ks;
  const int f0 = rank * W;
#pragma unroll
  for (int u = 0; u < NT2; ++u) {
    if (!act[u]) continue;
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      const int i = row0 + rg2[u] + RG * a;
      if (i >= k) continue;
#pragma unroll
      for (int h = 0; h < D4; ++h) {
        const int col = f0 + 4 * (cg2[u] + Q2 * h);
        const float o[4] = {acc[u][a][h].x, acc[u][a][h].y, acc[u][a][h].z,
                            acc[u][a][h].w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < d) pl[(long long)i * (d + 1) + col + c] = o[c];
      }
    }
  }
}

template <int THREADS, int ROWS, int TR, int TC, int W>
static cudaError_t launch_partial(const float* scratch, float* part, int S, int k, int m,
                                  int d, int x_lane_stride, int chunk, int nsplit,
                                  float nsc, cudaStream_t stream) {
  using G = WdGeo<THREADS, ROWS, TR, TC, W>;
  auto kernel = phi_wide_d_partial<THREADS, ROWS, TR, TC, W>;
  static bool ready[64] = {};  // the attribute, set once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G::SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const WdSlices sl(d);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((k + ROWS - 1) / ROWS * sl.c), (unsigned)S, (unsigned)nsplit);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = G::SMEM;
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
// same from the WD_* constants, and chip_smoke.py checks the two).
extern "C" long long phi_wide_d_scratch_bytes(int S, int k, int m, int d,
                                              int x_lane_stride) {
  return (long long)sizeof(float) * WdScratch(S, k, m, d, x_lane_stride).total;
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// s (S, m, d) the scores; scratch phi_wide_d_scratch_bytes() bytes, 16-byte
// aligned; part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32,
// contiguous, on `device`; 1 ≤ d ≤ 2432 (the wrapper routes 128 < d here);
// chunk a multiple of WD_COLS.  Launches the pre-pass, the partial sums (in
// clusters of the d-slices) and the finalize on `stream`, allocates nothing,
// does not synchronise; returns the cudaGetLastError() code.
extern "C" int phi_wide_d_launch(const void* y, const void* x, const void* s,
                                 void* scratch, void* part, void* out, int S, int k,
                                 int m, int d, int x_lane_stride, int chunk, int nsplit,
                                 float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > WD_MAX_D || chunk % WD_COLS) return (int)cudaErrorInvalidValue;
  float* fscratch = static_cast<float*>(scratch);
  float* fpart = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WdScratch sc(S, k, m, d, x_lane_stride);
  // (k_pad and m_pad are multiples of WD_PRE_ROWS)
  const int ny = (int)((long long)sc.sl.c * S * sc.k_pad / WD_PRE_ROWS);
  const int nx = (int)((long long)sc.sl.c * sc.sx * sc.m_pad / WD_PRE_ROWS);
  const long long xs4 = (long long)sc.sl.c * S * sc.m_pad * (sc.sl.ls / 4);
  const long long want = (xs4 + WD_PRE_THREADS - 1) / WD_PRE_THREADS;
  const int nxs = (int)(want < 4096 ? want : 4096);
  phi_wide_d_prepass<<<ny + nx + nxs, WD_PRE_THREADS, 0, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<const float*>(s), fscratch, S, k, m, d, x_lane_stride, ny, nx,
      2.0f * inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float nsc = -OT_LOG2E * inv_h;
  err = d <= WD_NARROW_MAX_D
            ? launch_partial<WD_THREADS, WD_ROWS, 8, 8, WD_SLICE>(
                  fscratch, fpart, S, k, m, d, x_lane_stride, chunk, nsplit, nsc, st)
            : launch_partial<WD_WIDE_THREADS, WD_WIDE_ROWS, 4, 8, WD_WIDE_SLICE>(
                  fscratch, fpart, S, k, m, d, x_lane_stride, chunk, nsplit, nsc, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_phi_finalize(fpart, static_cast<const float*>(y),
                                  static_cast<float*>(out), nsplit, S, k, d, m, inv_h,
                                  st);
}
