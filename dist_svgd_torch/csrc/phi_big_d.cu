// Fused SVGD φ for feature dims 8 < d ≤ 128, exact f32 tier — hand-written
// for Hopper (sm_90a).
//
// Replaces: dist_svgd_tpu/ops/pallas_svgd.py, `_phi_kernel` (reached through
// `phi_pallas`) in its exact tier (Precision.HIGHEST), together with its
// `_phi_tail` epilogue.  The bf16x3 tier (`_dot3`) is phi_big_d_bf16x3.cu.
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
// it.  A splice call (8 lanes × 1250 rows × 10,000, d = 61) is 1e8 pairs at
// two length-d products a pair (the Gram y·xᵀ and the drive K·xs), 2d
// FFMAs, on a few MB of inputs.  The tier's contract is f32
// (Precision.HIGHEST), so the tensor cores are off the table and the floor
// is the CUDA cores' FFMA rate: each FFMA must cost about one issue slot,
// and the 128-bit shared loads that feed a warp's FFMAs (four shared-memory
// cycles each) must keep pace with them, so a thread's tiles are as large
// as its registers allow.
//
// What the design does about it — both contractions are small GEMMs:
// - a pre-pass (phi_big_d_prepass, same launch) writes y, x and xs (from s
//   and x: two torch ops and their launches fewer a call) into
//   wrapper-allocated scratch with rows padded with zeros from d to a row
//   stride L (a multiple of 4 floats with L/4 odd, so that eight
//   consecutive rows of float4s hit eight distinct bank groups), the row
//   count padded to whole tiles, and the row norms ‖y‖², ‖x‖² (+inf for a
//   padding column, whose K is then exactly 0: no masks in the loop);
// - the norms are the same FMA chain, in the same order, as the Gram dot of
//   the main loop, so a pair whose y_i and x_j are the same bits (the
//   diagonal in all_particles) gets d² = 0 exactly, as in f64;
// - a block of BD_THREADS owns BD_ROWS output rows of one lane (staged once,
//   with their norms) and walks its m range BD_COLS columns a tile:
//   phase 1 gives each thread a BD_TR × BD_TC register tile of the Gram
//   (8 × 8: 16 128-bit shared loads along d for 256 FFMAs); its epilogue
//   (clamp, one scale, one ex2.approx.ftz, row-sum) stores K to shared
//   memory as float4s; phase 2 gives each thread BD_TR rows × BD_TD of d of
//   the drive, fed by 128-bit loads of K and xs (16 for 256 FFMAs);
// - the x and xs tiles are copied with cp.async into single buffers that
//   alternate with the phases: x for the next tile loads while phase 2
//   reads xs, xs while phase 1 reads x, so two blocks fit on an SM;
// - a thread's rows are strided by the row groups and its columns by the
//   column groups, so that the row groups of a warp and the column groups
//   of a quarter-warp fall in distinct bank groups; phase 2 reads the K
//   float4s in the order phase 1 wrote them, with xs rows to match;
// - the m axis is split across `nsplit` blocks per row tile (the wrapper's
//   split at BD_BLOCKS_PER_SM: a block holds ~12 tiles at the paths'
//   shapes, so the last wave of blocks is short) and phi_finalize
//   (phi_common.cuh) reduces the partials in a fixed order —
//   deterministic, no float atomics.
#include <cuda_runtime.h>
#include <math.h>

#include "ot_common.cuh"  // ot_ex2, OT_LOG2E
#include "phi_common.cuh"

constexpr int BD_THREADS = 128;
constexpr int BD_ROWS = 128;  // output rows per block: BD_RG row groups × BD_TR
constexpr int BD_COLS = 64;   // interaction rows per shared-memory tile
// A thread's register tiles: BD_TR rows × BD_TC columns of the Gram (phase
// 1), BD_TR rows × BD_TD features of the drive (phase 2).
constexpr int BD_TR = 8;
constexpr int BD_TC = 8;
constexpr int BD_TD = 8;
// The m-split's target of blocks an SM that the wrapper gives this kernel
// (ops/cuda_svgd.py:_KERNELS; the kernel takes the split as `chunk`,
// `nsplit`), recorded beside the rows a block it was measured with: of 2,
// 4, 8, 12 and 16, 8 was the fastest at the splice and Covertype lanes on
// an H100 (tools/ot_ab.py), and 8 × 8 tiles at 128 threads beat 8 × 4 at
// 256.
constexpr int BD_BLOCKS_PER_SM = 8;
constexpr int BD_MAX_D = 128;  // the wrapper refuses larger d
constexpr int BD_PRE_THREADS = 256;

constexpr int BD_RG = BD_ROWS / BD_TR;   // row groups
constexpr int BD_CG = BD_COLS / BD_TC;   // column groups of phase 1
constexpr int BD_KL4 = BD_COLS / 4 + 1;  // float4s a K row (odd)
static_assert(BD_RG * BD_CG == BD_THREADS, "phase 1 maps one tile a thread");
static_assert(BD_TC % 4 == 0 && BD_TD % 4 == 0, "tiles of whole float4s");
static_assert(BD_CG <= 32 && (BD_CG & (BD_CG - 1)) == 0, "a row group's lanes");

// d padded to whole drive tiles (a multiple of BD_TD), and the row stride
// L (floats) of every padded row in scratch and in shared memory: L/4 odd.
__host__ __device__ inline int bd_dp(int d) { return (d + BD_TD - 1) / BD_TD * BD_TD; }
__host__ __device__ inline int bd_ld(int d) {
  const int dp = bd_dp(d);
  return (dp / 4) % 2 ? dp : dp + 4;
}

struct BdScratch {  // offsets in floats, every region 16-byte aligned
  long long yp, xp, xsp, y2, x2, total;
  int k_pad, m_pad, ld, sx;
  __host__ __device__ BdScratch(int S, int k, int m, int d, int x_lane_stride) {
    k_pad = (k + BD_ROWS - 1) / BD_ROWS * BD_ROWS;
    m_pad = (m + BD_COLS - 1) / BD_COLS * BD_COLS;
    ld = bd_ld(d);
    sx = x_lane_stride ? S : 1;
    yp = 0;
    xp = yp + (long long)S * k_pad * ld;
    xsp = xp + (long long)sx * m_pad * ld;
    y2 = xsp + (long long)S * m_pad * ld;
    x2 = y2 + (long long)S * k_pad;
    total = x2 + (long long)sx * m_pad;
  }
};

// xs = s − (2/h)·x as the wrapper's torch ops round it: (2/h)·x, then the
// difference (c2 = 2·inv_h in f32 is torch's f32 scalar 2/h: a power of two
// times the same rounding).
__device__ __forceinline__ float drive_operand(float s, float x, float c2) {
  return __fsub_rn(s, __fmul_rn(c2, x));
}

// Blocks [0, ny) pad the y rows and take their norms, one thread a row;
// [ny, ny + nx) the x rows; the rest form xs from s and x, one thread a
// float4.
static __global__ void __launch_bounds__(BD_PRE_THREADS)
phi_big_d_prepass(const float* __restrict__ y, const float* __restrict__ x,
                  const float* __restrict__ s, float* __restrict__ scratch,
                  int S, int k, int m, int d, int x_lane_stride, int ny, int nx,
                  float c2) {
  const BdScratch sc(S, k, m, d, x_lane_stride);
  const int L4 = sc.ld / 4;
  const int b = blockIdx.x;
  if (b < ny + nx) {
    const bool is_y = b < ny;
    const int npad = is_y ? sc.k_pad : sc.m_pad;
    const int n = is_y ? k : m;
    const int row = (is_y ? b : b - ny) * BD_PRE_THREADS + threadIdx.x;
    if (row >= (is_y ? S : sc.sx) * npad) return;
    const int l = row / npad;
    const int r = row - l * npad;
    const bool valid = r < n;
    const float* src = (is_y ? y : x) + ((long long)l * n + r) * d;
    float4* dst = reinterpret_cast<float4*>(scratch + (is_y ? sc.yp : sc.xp)) +
                  (long long)row * L4;
    float s2 = 0.f;  // the Gram's chain: one fmaf a feature, in order
    for (int c4 = 0; c4 < L4; ++c4) {
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = 4 * c4 + t;
        v[t] = valid && c < d ? src[c] : 0.f;
        s2 = fmaf(v[t], v[t], s2);
      }
      dst[c4] = make_float4(v[0], v[1], v[2], v[3]);
    }
    scratch[(is_y ? sc.y2 : sc.x2) + row] = valid ? s2 : (is_y ? 0.f : INFINITY);
    return;
  }
  const long long total = (long long)S * sc.m_pad * L4;
  float4* dst = reinterpret_cast<float4*>(scratch + sc.xsp);
  for (long long e = (long long)(b - ny - nx) * BD_PRE_THREADS + threadIdx.x;
       e < total; e += (long long)(gridDim.x - ny - nx) * BD_PRE_THREADS) {
    const long long row = e / L4;
    const int c = 4 * (int)(e - row * L4);
    const int l = (int)(row / sc.m_pad);
    const int r = (int)(row - (long long)l * sc.m_pad);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < m) {
      const float* sr = s + ((long long)l * m + r) * d;
      const float* xr = x + ((long long)(x_lane_stride ? l : 0) * m + r) * d;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = c + t < d ? drive_operand(sr[c + t], xr[c + t], c2) : 0.f;
    }
    dst[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void bd_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void bd_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bd_cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// `n4` contiguous float4s, global to shared, spread over the block.
__device__ __forceinline__ void bd_copy(float4* dst, const float* src, int n4) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int e = threadIdx.x; e < n4; e += BD_THREADS) bd_cp_async16(dst + e, s4 + e);
}

// NT2: drive tiles a thread: BD_RG·⌈d/BD_TD⌉ tiles over BD_THREADS threads.
template <int NT2>
__global__ void __launch_bounds__(BD_THREADS)
phi_big_d_partial(const float* __restrict__ scratch, float* __restrict__ part,
                  int S, int k, int m, int d, int x_lane_stride, int chunk,
                  float nsc) {
  constexpr int C4 = BD_TC / 4;  // float4s of a thread's K row (phase 1)
  constexpr int D4 = BD_TD / 4;  // float4s of a thread's drive row (phase 2)
  const BdScratch sc(S, k, m, d, x_lane_stride);
  const int L4 = sc.ld / 4;
  const int Q = bd_dp(d) / 4;    // float4s of d the Gram runs over
  const int Q2 = bd_dp(d) / BD_TD;  // drive column groups
  extern __shared__ float4 smem4[];
  float4* sy = smem4;                                 // BD_ROWS × L4
  float4* sx = sy + BD_ROWS * L4;                     // BD_COLS × L4
  float4* sxs = sx + BD_COLS * L4;                    // BD_COLS × L4
  float4* sk = sxs + BD_COLS * L4;                    // BD_ROWS × BD_KL4
  float* sy2 = reinterpret_cast<float*>(sk + BD_ROWS * BD_KL4);  // BD_ROWS
  float* sx2 = sy2 + BD_ROWS;                                    // BD_COLS

  const int tid = threadIdx.x;
  const int lane = blockIdx.y;
  const int split = blockIdx.z;
  const int row0 = blockIdx.x * BD_ROWS;
  const int xl = x_lane_stride ? lane : 0;
  const float* ypl = scratch + sc.yp + ((long long)lane * sc.k_pad + row0) * sc.ld;
  const float* xpl = scratch + sc.xp + (long long)xl * sc.m_pad * sc.ld;
  const float* xspl = scratch + sc.xsp + (long long)lane * sc.m_pad * sc.ld;
  const float* x2l = scratch + sc.x2 + (long long)xl * sc.m_pad;
  const int j0 = split * chunk;
  const int j1 = min(sc.m_pad, j0 + chunk);

  bd_copy(sy, ypl, BD_ROWS * L4);
  bd_copy(reinterpret_cast<float4*>(sy2),
          scratch + sc.y2 + (long long)lane * sc.k_pad + row0, BD_ROWS / 4);
  bd_copy(sx, xpl + (long long)j0 * sc.ld, BD_COLS * L4);
  bd_copy(reinterpret_cast<float4*>(sx2), x2l + j0, BD_COLS / 4);
  bd_cp_commit();
  bd_copy(sxs, xspl + (long long)j0 * sc.ld, BD_COLS * L4);
  bd_cp_commit();

  // phase 1: rows rg + BD_RG·a, columns cg + BD_CG·i; the K of columns
  // cg + BD_CG·(4v + t), t < 4, is the float4 cg + BD_CG·v of its row
  const int rg = tid / BD_CG;
  const int cg = tid % BD_CG;
  // phase 2: tile u is rows rg2 + BD_RG·a, the float4s cg2 + Q2·h of d
  int rg2[NT2], cg2[NT2];
  bool act[NT2];
#pragma unroll
  for (int u = 0; u < NT2; ++u) {
    const int t2 = tid + u * BD_THREADS;
    rg2[u] = t2 / Q2;
    cg2[u] = t2 - rg2[u] * Q2;
    act[u] = rg2[u] < BD_RG;
  }
  float4 acc[NT2][BD_TR][D4];
#pragma unroll
  for (int u = 0; u < NT2; ++u)
#pragma unroll
    for (int a = 0; a < BD_TR; ++a)
#pragma unroll
      for (int h = 0; h < D4; ++h) acc[u][a][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  float ks[BD_TR], y2r[BD_TR];
#pragma unroll
  for (int a = 0; a < BD_TR; ++a) ks[a] = 0.f;

  for (int t0 = j0; t0 < j1; t0 += BD_COLS) {
    const bool more = t0 + BD_COLS < j1;
    bd_cp_wait1();  // all but the newest group (xs of this tile) landed
    __syncthreads();
    if (t0 == j0) {
#pragma unroll
      for (int a = 0; a < BD_TR; ++a) y2r[a] = sy2[rg + BD_RG * a];
    }
    // phase 1: the Gram tile, one fmaf a feature in order
    float dot[BD_TR][BD_TC];
#pragma unroll
    for (int a = 0; a < BD_TR; ++a)
#pragma unroll
      for (int i = 0; i < BD_TC; ++i) dot[a][i] = 0.f;
    const float4* ya = sy + rg * L4;
    const float4* xb = sx + cg * L4;
#pragma unroll 2
    for (int c4 = 0; c4 < Q; ++c4) {
      float4 xv[BD_TC];
#pragma unroll
      for (int i = 0; i < BD_TC; ++i) xv[i] = xb[i * BD_CG * L4 + c4];
#pragma unroll
      for (int a = 0; a < BD_TR; ++a) {
        const float4 yv = ya[a * BD_RG * L4 + c4];
#pragma unroll
        for (int i = 0; i < BD_TC; ++i) {
          dot[a][i] = fmaf(yv.x, xv[i].x, dot[a][i]);
          dot[a][i] = fmaf(yv.y, xv[i].y, dot[a][i]);
          dot[a][i] = fmaf(yv.z, xv[i].z, dot[a][i]);
          dot[a][i] = fmaf(yv.w, xv[i].w, dot[a][i]);
        }
      }
    }
    // K = 2^(−max(y² + x² − 2·dot, 0)·log2(e)/h), stored as float4s
    float x2v[BD_TC];
#pragma unroll
    for (int i = 0; i < BD_TC; ++i) x2v[i] = sx2[cg + BD_CG * i];
#pragma unroll
    for (int a = 0; a < BD_TR; ++a) {
      float kv[BD_TC];
#pragma unroll
      for (int i = 0; i < BD_TC; ++i) {
        const float d2 = fmaxf(fmaf(-2.f, dot[a][i], y2r[a] + x2v[i]), 0.f);
        kv[i] = ot_ex2(d2 * nsc);
        ks[a] += kv[i];
      }
#pragma unroll
      for (int v = 0; v < C4; ++v)
        sk[(rg + BD_RG * a) * BD_KL4 + cg + BD_CG * v] =
            make_float4(kv[4 * v], kv[4 * v + 1], kv[4 * v + 2], kv[4 * v + 3]);
    }
    __syncthreads();  // K is complete; x is free
    if (more) {
      bd_copy(sx, xpl + (long long)(t0 + BD_COLS) * sc.ld, BD_COLS * L4);
      bd_copy(reinterpret_cast<float4*>(sx2), x2l + t0 + BD_COLS, BD_COLS / 4);
    }
    bd_cp_commit();
    bd_cp_wait1();  // xs of this tile landed
    __syncthreads();
    // phase 2: the float4 q of a K row holds columns
    // q % BD_CG + BD_CG·(4·(q / BD_CG) + t), t < 4
#pragma unroll
    for (int u = 0; u < NT2; ++u) {
      if (!act[u]) continue;
      const float4* kr = sk + rg2[u] * BD_KL4;
      const float4* xr = sxs + cg2[u];
#pragma unroll 2
      for (int q = 0; q < BD_COLS / 4; ++q) {
        const int jb = q % BD_CG + BD_CG * 4 * (q / BD_CG);
        float4 xv[4][D4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int h = 0; h < D4; ++h) xv[t][h] = xr[(jb + BD_CG * t) * L4 + Q2 * h];
#pragma unroll
        for (int a = 0; a < BD_TR; ++a) {
          const float4 kq = kr[a * BD_RG * BD_KL4 + q];
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
    if (more) bd_copy(sxs, xspl + (long long)(t0 + BD_COLS) * sc.ld, BD_COLS * L4);
    bd_cp_commit();
  }

  // the row-sums of the BD_CG column groups of a row group (neighbouring
  // lanes), combined in a fixed order
#pragma unroll
  for (int a = 0; a < BD_TR; ++a) {
    float v = ks[a];
#pragma unroll
    for (int o = 1; o < BD_CG; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    ks[a] = v;
  }
  float* pl = part + ((long long)split * S + lane) * k * (d + 1);
  if (cg == 0) {
#pragma unroll
    for (int a = 0; a < BD_TR; ++a) {
      const int i = row0 + rg + BD_RG * a;
      if (i < k) pl[(long long)i * (d + 1) + d] = ks[a];
    }
  }
#pragma unroll
  for (int u = 0; u < NT2; ++u) {
    if (!act[u]) continue;
#pragma unroll
    for (int a = 0; a < BD_TR; ++a) {
      const int i = row0 + rg2[u] + BD_RG * a;
      if (i >= k) continue;
#pragma unroll
      for (int h = 0; h < D4; ++h) {
        const int col = 4 * (cg2[u] + Q2 * h);
        const float o[4] = {acc[u][a][h].x, acc[u][a][h].y, acc[u][a][h].z,
                            acc[u][a][h].w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < d) pl[(long long)i * (d + 1) + col + c] = o[c];
      }
    }
  }
}

template <int NT2>
static cudaError_t launch_partial(const float* scratch, float* part, int S, int k,
                                  int m, int d, int x_lane_stride, int chunk,
                                  int nsplit, float nsc, cudaStream_t stream) {
  // the most shared memory any d takes (d = BD_MAX_D), set once a device
  constexpr int L4_MAX = BD_MAX_D / 4 + 1;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !ready[dev]) {
    err = cudaFuncSetAttribute(
        phi_big_d_partial<NT2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float4) * ((BD_ROWS + 2 * BD_COLS) * L4_MAX + BD_ROWS * BD_KL4) +
              sizeof(float) * (BD_ROWS + BD_COLS)));
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int L4 = bd_ld(d) / 4;
  const size_t smem = sizeof(float4) * ((size_t)(BD_ROWS + 2 * BD_COLS) * L4 +
                                        (size_t)BD_ROWS * BD_KL4) +
                      sizeof(float) * (BD_ROWS + BD_COLS);
  const dim3 grid((k + BD_ROWS - 1) / BD_ROWS, S, nsplit);
  phi_big_d_partial<NT2><<<grid, BD_THREADS, smem, stream>>>(
      scratch, part, S, k, m, d, x_lane_stride, chunk, nsc);
  return cudaGetLastError();
}

// Bytes of scratch the launch below needs (ops/cuda_svgd.py computes the
// same from BD_ROWS, BD_COLS and bd_ld, and chip_smoke.py checks the two).
extern "C" long long phi_big_d_scratch_bytes(int S, int k, int m, int d,
                                             int x_lane_stride) {
  return (long long)sizeof(float) * BdScratch(S, k, m, d, x_lane_stride).total;
}

// y (S, k, d); x (m, d) with x_lane_stride 0, or (S, m, d) with stride m·d;
// s (S, m, d) the scores; scratch phi_big_d_scratch_bytes() bytes, 16-byte
// aligned;
// part (nsplit, S, k, d + 1) scratch; out (S, k, d).  All f32, contiguous,
// on `device`; 8 < d ≤ 128; chunk a multiple of BD_COLS.  Launches the
// pre-pass, the partial sums and the finalize on `stream`, allocates
// nothing, does not synchronise; returns the cudaGetLastError() code.
extern "C" int phi_big_d_launch(const void* y, const void* x, const void* s,
                                void* scratch, void* part, void* out, int S, int k,
                                int m, int d, int x_lane_stride, int chunk,
                                int nsplit, float inv_h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > BD_MAX_D || chunk % BD_COLS) return (int)cudaErrorInvalidValue;
  float* fscratch = static_cast<float*>(scratch);
  float* fpart = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BdScratch sc(S, k, m, d, x_lane_stride);
  const int ny = (int)(((long long)S * sc.k_pad + BD_PRE_THREADS - 1) / BD_PRE_THREADS);
  const int nx = (int)(((long long)sc.sx * sc.m_pad + BD_PRE_THREADS - 1) / BD_PRE_THREADS);
  const long long xs4 = (long long)S * sc.m_pad * (sc.ld / 4);
  const long long want = (xs4 + BD_PRE_THREADS - 1) / BD_PRE_THREADS;
  const int nxs = (int)(want < 4096 ? want : 4096);
  phi_big_d_prepass<<<ny + nx + nxs, BD_PRE_THREADS, 0, st>>>(
      static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<const float*>(s), fscratch, S, k, m, d, x_lane_stride, ny, nx,
      2.0f * inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float nsc = -OT_LOG2E * inv_h;
  err = BD_RG * (bd_dp(d) / BD_TD) <= BD_THREADS
            ? launch_partial<1>(fscratch, fpart, S, k, m, d, x_lane_stride, chunk,
                                nsplit, nsc, st)
            : launch_partial<2>(fscratch, fpart, S, k, m, d, x_lane_stride, chunk,
                                nsplit, nsc, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_phi_finalize(fpart, static_cast<const float*>(y),
                                  static_cast<float*>(out), nsplit, S, k, d, m, inv_h,
                                  st);
}
