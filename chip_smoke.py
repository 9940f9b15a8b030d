#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dist_svgd_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the eleven hand-written kernels from ``dist_svgd_torch/csrc/``
with ``nvcc`` (the φ kernels for small, big and wide feature dims in their
exact and bf16 tiers, the small-d kernel's no-exp timing probe, and the four
Sinkhorn kernels), holds each against its plain PyTorch version at the main
paths' shapes and at ragged shapes (at the 100k streaming route's shapes the
small-d φ, kmat_vec, plan_grad and the soft c-transform against the plain
version in float64 on a subset of rows: there the card's float32 plain
version can be the far one; the soft c-transform also on rows built to move
its lazy reference; the exact big-d φ also at the splice and Covertype lanes'
own h = 1, with its distance from the float64 φ on a subset of rows),
drives the north-star path (10,000-particle Bayesian logistic regression,
8 emulated shards, ``all_particles``) through ``DistSampler.run_steps``
without and with the Wasserstein term (Sinkhorn at 10,000 particles on the fused route, at
100,000 on the streaming route, with a profile of two streaming steps), drives the minibatched Covertype config
(BASELINE.json config 4) through its driver
``dist_svgd_torch/experiments/covertype.py`` in both φ tiers and through
the single-device ``Sampler``, drives the Bayesian neural network (BASELINE.json
config 5, d = 753) through its driver ``dist_svgd_torch/experiments/bnn.py``
at full width in both φ tiers, with the per-step median bandwidth and over
8 shards, runs the autotune tool ``dist_svgd_torch/tools/cuda_autotune.py``
(its default and ``--big-d`` modes, short chains), checks the φ policy's
pair-count lines on either side of their committed values, drives the
reference's own entry points (BASELINE.json configs 1-2) through
``dist_svgd_torch/experiments/logreg.py`` (config 1, the ``grid.sh``
sweep shape in every mode with and without the host-LP W2 term and in
both update rules, the full width with its history, and one Gauss-Seidel
step at full width — one φ launch a row, at shapes held against the plain
and the float64 φ in ``kernel_parity``) and ``gmm.py``, checks that each
path went through its kernels, and prints one JSON object per phase.  A
phase that fails raises, so the script exits non-zero; the last line,
printed only when every phase passed, is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

Without CUDA (``torch.cuda.is_available()`` false) it exits 1 and prints no
result.
"""

import json
import subprocess
import sys
import time

NORTH_STAR = dict(n=10_000, shards=8, step_size=3e-3, warm_steps=10, steps=500)
TRAJECTORY_STEPS = 20
BIG_D_STEPS = 50
TIMED_LAUNCHES = 50
PROFILE_STEPS = 20
# The W2 rows of bench.py: the north star with include_wasserstein=True,
# wasserstein_solver='sinkhorn' and the defaults (eps 0.05, iters 200, tol
# 1e-2, warm start), run_steps(·, 3e-3, h=10.0); at n = 100,000 one shard's
# solve is 12,500 × 100,000 pairs, past the streaming line.
W2_NORTH_STAR = dict(n=10_000, warm_steps=10, steps=100, h=10.0)
W2_STREAMING = dict(n=100_000, warm_steps=1, steps=5, h=10.0)
W2_TRAJECTORY = dict(steps=20, iters=50)
# The Covertype rows of bench.py (ct_bf16 against ct_f32): the driver's
# full-width sampler, 10 warm and 100 timed steps of 1e-4 per tier, in turns
# A, B, B, A; then a full 200-step run() of each tier for its accuracy.
COVERTYPE = dict(warm_steps=10, steps=100, step_size=1e-4, profile_steps=10,
                 trajectory_steps=20)
# The two tiers must reach the same test accuracy within this (same seed,
# so the same minibatch stream and init).
CT_ACC_TOL = 0.01
BANANA_BF16_STEPS = 50
# The BNN rows (BASELINE.json config 5, experiments/bnn.py defaults: boston,
# 500 particles, 50 hidden units — d = 753 — 1000 steps of 1e-3, B = 100
# rows, h = 1): the full run, the same with the per-step median bandwidth,
# short runs of the bf16x3 tier and of 8 shards (496 particles), a profile,
# 20-step trajectories of both tiers against their plain versions, and a
# small card-f32 / CPU-f64 reference (n_hidden 10 → d = 153, 16 particles).
BNN = dict(steps=1000, bf16_steps=50, dist_steps=50, dist_shards=8, dist_particles=496,
           profile_steps=20, trajectory_steps=20, small_hidden=10, small_n=16,
           small_steps=3, small_batch=32)
# Covertype through the single-device Sampler (--nproc 1): warm and timed
# steps of the driver's sampler.
COVERTYPE_NPROC1 = dict(warm_steps=3, steps=20)
W2_PROFILE_STEPS = 10
# Steps of the W2 streaming phase under the profiler (~150 ms each).
W2_STREAMING_PROFILE_STEPS = 2
# The soft c-transform's adversarial rows (ct_rescale_rows): a lane shape
# whose m-chunks are several tiles long, and the ragged shapes of the
# Sinkhorn parity table.
CT_RESCALE_SHAPES = [(8, 5000, 60_000, 3), (3, 1001, 777, 1), (2, 333, 517, 8)]
# Chain length of the autotune tool's rows in the smoke run (its own default
# is 50; the harvest is run through the tool, not here).
AUTOTUNE_ITERS = 5
# The φ lanes of the W2 streaming path (8 shards of 12,500 rows against
# 100,000 particles) and the rows of each lane held against a one-shot
# reference there (its whole Gram would be 40 GB in float32).
W2_STREAMING_PHI = (8, 12_500, 100_000, 3)
LANE_ROWS = 256
# The exact big-d φ at the paths' own h = 1 (splice, d = 61; Covertype's
# exact tier, d = 55): (S, k, m, d), role.  At h = 1 nearly every
# off-diagonal K underflows and φ rides the Gram diagonal's cancellation
# ‖y‖² + ‖x‖² − 2·y·x; the rows also print both versions' distance from the
# float64 φ on LANE_ROWS rows a lane.
BIG_D_SELF_CASES = [((8, 1250, 10_000, 61), "splice lanes h=1"),
                    ((8, 1250, 10_000, 55), "covertype lanes h=1")]
# The φ kernels whose rows carry the exp floor and whose pre-pass scratch
# the wrapper sizes (ops/cuda_svgd.py:_SCRATCH, checked against the
# library's own count).
BIG_D_KERNELS = ("phi_big_d", "phi_big_d_bf16x3")
# Wrapper calls of each big-d kernel profiled at its main shape (h = 1):
# device ms by kernel a call (the pre-pass, the partial sums, the finalize
# and the wrapper's torch ops), and the host's enqueue time a call.
BIG_D_PROFILE_CALLS = 10
# The wide-d φ kernels (d > 128): their rows carry the exp floor and their
# pre-pass scratch too (ops/cuda_svgd.py:_SCRATCH, checked as above).
WIDE_D_KERNELS = ("phi_wide_d", "phi_wide_d_bf16x3")
# The exact wide-d φ at the BNN paths' own h = 1 beyond the Sampler's lane
# (the "self h=1" rows): the throughput shape and the 8-shard BNN lanes,
# (S, k, m, d), role — held against the float64 φ on LANE_ROWS rows a lane
# within KERNEL_RTOL of its largest value, and printing the float32 plain
# version's distance from it and the kernel's from the plain version.  At
# d = 753 the f32 plain version is no reference at h = 1: φ rides K_ii,
# and its d²_ii = ‖y‖² + ‖x‖² − 2·y·x cancels three numbers near 1506 (on
# an H100 it lies ~1e-3 of max|φ| from the float64 φ at the throughput
# shape), where the kernel's is exactly 0.
WIDE_D_SELF_CASES = [((8, 1250, 10_000, 753), "throughput h=1"),
                     ((8, 62, 496, 753), "dist lanes h=1")]
# Wrapper calls of each wide-d kernel profiled at the BNN's one lane (h = 1,
# y = x = the driver's initial particles) and at the throughput shape
# (h = 2d): device ms by kernel a call, the host's enqueue time a call, and
# the clusters of the partial-sum kernel the card holds at once.
WIDE_D_PROFILE_CALLS = 10
# The streaming route's three 1e10-pair kernels (whose rows print their exp
# floor), and their rows at that route's shapes, (kernel, (S, k, m, d), role,
# seed), held against float64 on LANE_ROWS rows a lane; the kmat_vec and
# plan_grad "main" rows' seeds are those of their place in the Sinkhorn
# parity table (ot_cases in main()).  The c-transform rows are the soft form
# at the solve's warm start, both directions: ctransform(xs, ys, g) over the
# 100,000 previous particles, and ctransform(ys, xs, f) over a lane's 12,500.
STREAMING_OT = ("ot_kmat_vec", "ot_plan_grad", "ot_ctransform")
W2_STREAMING_OT = [("ot_kmat_vec", (8, 12_500, 100_000, 3), "main", 105),
                   ("ot_kmat_vec", (8, 100_000, 12_500, 3), "100k lanes transposed", 107),
                   ("ot_plan_grad", (8, 12_500, 100_000, 3), "main", 106),
                   ("ot_ctransform", (8, 12_500, 100_000, 3), "main", 124),
                   ("ot_ctransform", (8, 100_000, 12_500, 3), "100k lanes transposed", 125)]
# 'torch' past the blockwise line, (case, (S, k, m, d), line or None for the
# committed TORCH_BLOCKWISE_MIN_PAIRS): the 100k streaming lanes, 1e10 pairs,
# and the 10k lanes past a line patched down to 2^20.
BLOCKWISE_CASES = [("committed line", W2_STREAMING_PHI, None),
                   ("patched line", (8, 1250, 10_000, 3), 1 << 20)]
# A value each 'auto' gate is patched to in the auto_gates phase, so that a
# shape on either side of it runs on the card.
PATCHED_GATE = 1 << 12
W2_SYNC_STEPS = 20
# Timed launches of the Sinkhorn kernels' parity rows: the main rows at the
# 100k shapes (~10 ms a call), the other rows; the plain versions take
# 0.4–0.9 s a call at the 100k shapes, so fewer of those.
MAIN_100K_LAUNCHES = 20
OTHER_LAUNCHES = 10
PLAIN_100K_REPS = 5

# The reference's own entry points (BASELINE.json configs 1-2), through the
# port's drivers dist_svgd_torch/experiments/logreg.py and gmm.py:
# config 1 (experiments/logreg.py's defaults at 100 particles: banana fold
# 42, one shard, partitions, Jacobi, 100 steps of 1e-3); the reference's
# grid.sh shape (50 particles on 4 and 8 shards, banana, 10 steps, every
# mode, with and without the host-LP W2 term at h = 10, both update rules);
# the full width recorded (splice, d = 61, 10,000 particles, 8 shards,
# partitions, 100 steps with the history); one Gauss-Seidel step at full
# width (10,000 particles, 8 shards, all_particles: 1250 rows a shard, one
# φ launch a row); the GMM (config 2: the driver's 50 particles and
# config 2's 256, 500 steps of 1.0; a Gauss-Seidel run of GMM["gs_steps"],
# cut from 500 for time, not width).
LOGREG_DRIVER = dict(dataset="banana", fold=42, n=100, steps=100, step_size=1e-3)
LOGREG_GRID = dict(n=50, shards=(4, 8), steps=10, step_size=1e-3)
LOGREG_RECORD = dict(dataset="splice", fold=1, n=10_000, shards=8, steps=100, step_size=1e-3)
LOGREG_GS = dict(n=10_000, shards=8, step_size=1e-3)
GMM = dict(n=(50, 256), gs_steps=20)
# The φ kernels at those paths' own shapes, (kernel, (S, k, m, d), role):
# the GS probe, one row a lane against the lane's own view (all_particles
# and partitions at full width, the grid's d = 9 set at 4 shards of 3
# rows, and a 100-particle view), and the GMM's Jacobi lanes at d = 1;
# seeds from GS_PROBE_SEED, after every older row's.
GS_PROBE_CASES = [("phi_small_d", (8, 1, 10_000, 3), "gs probe all_particles"),
                  ("phi_small_d", (8, 1, 1250, 3), "gs probe partitions"),
                  ("phi_small_d", (1, 1, 100, 3), "gs probe 100 particles"),
                  ("phi_big_d", (8, 1, 10_000, 61), "gs probe splice"),
                  ("phi_big_d", (4, 1, 12, 9), "gs probe d=9"),
                  ("phi_small_d", (1, 50, 50, 1), "gmm lane d=1"),
                  ("phi_small_d", (1, 256, 256, 1), "gmm config 2 lane d=1")]
GS_PROBE_SEED = 500

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel parity tolerance: max|Δ| ≤ KERNEL_RTOL · max|φ_plain|.  Both sides
# are float32; they sum the m = 10,000 pair terms in different orders (the
# kernel in chunked sequential FMA chains plus a fixed-order split reduction,
# the plain version through cuBLAS), and the big-d distance form cancels in
# y² + x² − 2·y·x, so ~1e-6 relative is expected; 1e-4 leaves room without
# hiding a wrong index.
KERNEL_RTOL = 1e-4
# The Sinkhorn kernels (ops/cuda_ot.py).  kexp: elementwise |Δ| ≤ 1e-5·|plain|
# — kernel and plain version build the same exponent with the same roundings
# (per-dim differences, no FMA contraction) and both call the full-precision
# float32 exp, so they differ by the exp's last-ulp error at most.  The
# row reductions (kmat_vec, plan_grad, hard c-transform): max|Δ| ≤
# 1e-4·max|plain|, as for φ — the kernel sums its m terms in chunked
# sequential chains with a fixed-order split merge, the plain version
# through cuBLAS or torch's reduction tree, ~1e-6 relative apart.  Soft
# c-transform: max|Δ| ≤ 1e-4·(1 + max|plain|) — a log, so its error is
# absolute (the relative error of the sum it takes the log of) and its value
# can sit near 0.  plan_grad: max|Δ| ≤ 1e-4·max_i(max_c|y_ic|·Σ_j P_ij) — its
# epilogue y·Σ_j P_ij − Σ_j P_ij·x_j cancels (the terms run to tens of times
# the result at these inputs), so its rounding scales with the terms it
# subtracts, not with the result.
KEXP_RTOL = 1e-5
REDUCE_RTOL = 1e-4
SOFT_CT_TOL = 1e-4
# Trajectory tolerance: max|θ_cuda − θ_torch| ≤ TRAJ_RTOL · max|θ| after 20
# steps from the same init.  Per-step φ agreement is ~1e-6 of max|φ|, scaled
# by the step size, so the two float32 trajectories agree far below this.
TRAJ_RTOL = 1e-4
# Small-input reference: the port on the card (float32, phi_impl='cuda')
# against the port on the CPU (float64, phi_impl='torch'), 3 steps, all
# three exchange modes — float32 rounding of O(1) particles.
SMALL_RTOL = 1e-5
# The same with the W2 term (Sinkhorn, sinkhorn_tol=None, 200 iterations):
# the card's float32 fused route against the CPU's float64 torch route.
# Both solve the same fixpoint; the float32 potentials after 200 scaling
# iterations carry ~1e-5 relative error, which the update scales by ε·h.
W2_SMALL_RTOL = 1e-4

KERNELS = {
    "phi_small_d": {
        "source": "dist_svgd_torch/csrc/phi_small_d.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_svgd.py:121",
        # per pair: d subtractions + d FMAs (distance), the 1/h scale, the
        # row-sum add, d FMAs (drive); plus one exp
        "flops_per_pair": lambda d: 5 * d + 2,
    },
    "phi_big_d": {
        "source": "dist_svgd_torch/csrc/phi_big_d.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_svgd.py:80",
        # per pair: d FMAs (distance dot), y²+x²−2·dot (3), clamp, 1/h scale,
        # row-sum add, d FMAs (drive); plus one exp
        "flops_per_pair": lambda d: 4 * d + 6,
    },
    "phi_small_d_bf16": {
        "source": "dist_svgd_torch/csrc/phi_small_d.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_svgd.py:121 (bf16 tier)",
        # as the exact tier (the bf16 rounding of the exponent not counted)
        "flops_per_pair": lambda d: 5 * d + 2,
    },
    "phi_wide_d": {
        "source": "dist_svgd_torch/csrc/phi_wide_d.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_svgd.py:80 (d > 128)",
        # as the big-d kernel
        "flops_per_pair": lambda d: 4 * d + 6,
    },
    "phi_wide_d_bf16x3": {
        "source": "dist_svgd_torch/csrc/phi_wide_d_bf16x3.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_svgd.py:80 (bf16x3 tier, d > 128)",
        # as the big-d bf16x3 kernel
        "flops_per_pair": lambda d: 8 + 2 * -(-d // 16),
        "tc_flops_per_pair": lambda d: 12 * d,
    },
    "phi_small_d_noexp": {
        "source": "dist_svgd_torch/csrc/phi_small_d.cu",
        "replaces": "tools/pallas_autotune.py:129 (_noexp_kernel)",
        # per pair: d subtractions + d FMAs (distance), min, negation, the
        # row-sum add, d FMAs (drive); no exp
        "flops_per_pair": lambda d: 5 * d + 3,
    },
    "phi_big_d_bf16x3": {
        "source": "dist_svgd_torch/csrc/phi_big_d_bf16x3.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_svgd.py:80 (bf16x3 tier)",
        # CUDA cores, per pair: y²+x²−2·dot (3), clamp, 1/h scale, row-sum
        # add, the hi/lo split of K (2), and one f32 add of a Gram and of a
        # drive partial per 16-deep k-step; plus one exp
        "flops_per_pair": lambda d: 8 + 2 * -(-d // 16),
        # tensor cores, per pair: three bf16 products of depth d for the
        # distance and three for the drive, 2 flops each
        "tc_flops_per_pair": lambda d: 12 * d,
    },
    # The Sinkhorn kernels count the distance as d subtractions, d products
    # and d − 1 sums plus the clamp (3d), all without FMA contraction.
    "ot_ctransform": {
        "source": "dist_svgd_torch/csrc/ot_ctransform.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_ot.py:136",
        # hard: distance, − p, min (3d+2); soft: distance, p −, ·inv_reg,
        # compare, e − max, sum add (3d+5) plus one exp
        "flops_per_pair": lambda d, soft=True: 3 * d + (5 if soft else 2),
    },
    "ot_kexp": {
        "source": "dist_svgd_torch/csrc/ot_kexp.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_ot.py:242",
        # distance, f + g, − d², ·inv_reg (3d+4) plus one exp
        "flops_per_pair": lambda d: 3 * d + 4,
    },
    "ot_kmat_vec": {
        "source": "dist_svgd_torch/csrc/ot_kmat_vec.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_ot.py:514",
        # distance and exponent (3d+4), r FMAs (2r) plus one exp
        "flops_per_pair": lambda d, r=1: 3 * d + 4 + 2 * r,
    },
    "ot_plan_grad": {
        "source": "dist_svgd_torch/csrc/ot_plan_grad.cu",
        "replaces": "dist_svgd_tpu/ops/pallas_ot.py:297",
        # distance and exponent (3d+4), row-sum add, d FMAs (2d) plus one exp
        "flops_per_pair": lambda d: 5 * d + 5,
    },
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def phi_counts(**launched):
    """The φ launch counts a run should show: ``launched``, and 0 for every
    other φ kernel."""
    from dist_svgd_torch.ops import cuda_svgd

    return {name: launched.get(name, 0) for name in cuda_svgd.launch_counts}


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` warmed calls, timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops, nbytes, tc_flops=0.0):
    """Least time the card could take for one call: the largest of the bytes
    it must move (each input read once, each output written once) over HBM
    bandwidth, its float32 operations over the float32 peak and its bf16
    tensor-core operations over the bf16 peak."""
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = max(flops / PEAK_F32_FLOPS, tc_flops / PEAK_BF16_TC_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def phi_work(name, S, k, m, d, x_numel):
    """(flops, bytes, tensor-core flops) of one φ call: y, x, s read, φ
    written; float32."""
    nbytes = 4 * (S * k * d + x_numel + S * m * d + S * k * d)
    tc = KERNELS[name].get("tc_flops_per_pair", lambda d: 0)(d)
    return S * k * m * KERNELS[name]["flops_per_pair"](d), nbytes, S * k * m * tc


def ot_work(name, S, k, m, d, r=1, soft=True):
    """(flops, bytes) of one Sinkhorn-kernel call on lanes of k rows and m
    columns: rows and columns read, the per-lane potentials and right-hand
    sides read, the output written; float32."""
    per_pair = KERNELS[name]["flops_per_pair"]
    coords = S * (k + m) * d
    if name == "ot_ctransform":
        return S * k * m * per_pair(d, soft), 4 * (coords + S * m + S * k)
    if name == "ot_kexp":
        return S * k * m * per_pair(d), 4 * (coords + S * (k + m) + S * k * m)
    if name == "ot_kmat_vec":
        return S * k * m * per_pair(d, r), 4 * (coords + S * (k + m) + S * (m + k) * r)
    return S * k * m * per_pair(d), 4 * (coords + S * (k + m) + S * k * d)


def phi_inputs(S, k, m, d, seed, shared_x=True):
    """Particle-like inputs: x is the interaction set, y the lanes' blocks of
    it (as in all_particles), s score-like."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, d, generator=g)
    if shared_x:
        idx = torch.randint(0, m, (S, k), generator=g)
        y = x[idx]
    else:
        x = torch.randn(S, m, d, generator=g)
        y = torch.randn(S, k, d, generator=g)
    s = torch.randn(S, m, d, generator=g)
    return [t.cuda().contiguous() for t in (y, x, s)]


def ot_inputs(S, k, m, d, seed):
    """Lanes of W2-like inputs in the solve's reg-rescaled units: points
    spread so that mean C ≈ 1/eps = 20, and f, g the cold start's hard
    c-transform pair (so exp(f + g − C) ≤ 1 with a 1 in every row and
    column, as in a real solve), a positive right-hand side."""
    import torch

    from dist_svgd_torch.ops import cuda_ot

    g = torch.Generator(device="cpu").manual_seed(seed)
    scale = (20.0 / (2 * d)) ** 0.5
    rows = (scale * torch.randn(S, k, d, generator=g)).cuda()
    cols = (scale * torch.randn(S, m, d, generator=g)).cuda()
    f = cuda_ot.ctransform_reduce(rows, cols, torch.zeros(S, m, device="cuda"), soft=False)
    gpot = cuda_ot.ctransform_reduce(cols, rows, f, soft=False)
    p = (4.0 * torch.randn(S, m, generator=g)).cuda()
    rhs = (0.5 + torch.rand(S, m, 8, generator=g)).cuda()
    return rows, cols, f, gpot, p, rhs


def ot_check(name, got, want, soft=False, terms=0.0):
    """(ok, max|Δ|, the tolerance, max|plain|) under the tolerance rules
    above; ``terms`` is plan_grad's term scale."""
    import torch

    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    finite = bool(torch.isfinite(got).all())
    if name == "ot_kexp":
        ok = bool(((got - want).abs() <= KEXP_RTOL * want.abs()).all())
        return finite and ok, err, f"|d| <= {KEXP_RTOL}*|plain| elementwise", scale
    tol = SOFT_CT_TOL * (1.0 + scale) if soft else REDUCE_RTOL * max(scale, terms)
    return finite and err <= tol, err, tol, scale


def exp_floor_ms(pairs):
    """Least time the card's MUFU pipes take for one exp a pair: 16 a clock
    on each SM, at the SM clock that nvidia-smi reads now."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.sm").split()[0])
    return 1e3 * pairs / (16 * sms * mhz * 1e6), mhz


def check_scratch(name, S, k, m, d, x_lanes):
    """The wrapper's pre-pass scratch size for kernel ``name`` against the
    library's ``<name>_scratch_bytes``; returns it, raises on a mismatch."""
    import ctypes

    from dist_svgd_torch.ops import _build, cuda_svgd

    fn = getattr(_build.library(cuda_svgd._KERNELS[name][0]), f"{name}_scratch_bytes")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    ours = cuda_svgd._SCRATCH[name](S, k, m, d, x_lanes)
    theirs = fn(S, k, m, d, m * d if x_lanes > 1 else 0)
    if ours != theirs:
        raise AssertionError(f"{name} scratch at {(S, k, m, d, x_lanes)}: the wrapper "
                             f"allocates {ours} bytes, the kernel needs {theirs}")
    return ours


def plan_grad_terms(rows, cols, f, g):
    """plan_grad's term scale ``max_i(max_c|y_ic|·Σ_j P_ij)`` (the tolerance
    rules above), from the plain version in the inputs' dtype."""
    import torch

    from dist_svgd_torch.ops import cuda_ot

    rowsum = cuda_ot.kmat_vec_plain(rows, cols, f, g, torch.ones_like(g))
    return float((rows.abs().amax(dim=-1) * rowsum).max())


def ot_lanes_f64_rows(timing):
    """The streaming route's row-reduction kernels at that route's own
    shapes (8 lanes of 12,500 rows against 100,000 particles, and the other
    way round), against float64.  The kernel runs at the full shape, so it
    keeps its real m-split; the first LANE_ROWS rows of every lane are held
    against the plain version run in float64 on those rows (rows are
    independent), within the tolerance rules above, scaled by the float64
    value.  Each row also prints the card's float32 plain version's distance
    from the float64 value on the same rows, and the kernel's from it; the
    kernel is timed at the full shape beside its bound and its exp floor.
    Emits one row per case, fills ``timing``'s "main" entries and raises on
    a failed one."""
    import torch

    from dist_svgd_torch.ops import cuda_ot

    for name, (S, k, m, d), role, seed in W2_STREAMING_OT:
        rows, cols, f, gpot, _, rhs = ot_inputs(S, k, m, d, seed)
        soft = name == "ot_ctransform"
        opts = {}
        if name == "ot_kmat_vec":
            kern, plain = cuda_ot.kmat_vec_cuda, cuda_ot.kmat_vec_plain
            args = (rows, cols, f, gpot, rhs[..., 0].contiguous())
            opts = {"r": 1}
        elif name == "ot_plan_grad":
            kern, plain = cuda_ot.plan_grad_cuda, cuda_ot.plan_grad_plain
            args = (rows, cols, f, gpot)
        else:  # the soft c-transform against the column potential g
            kern = lambda *a: cuda_ot.ctransform_reduce_cuda(*a, soft=True)  # noqa: E731
            plain = lambda *a: cuda_ot.ctransform_reduce_plain(*a, soft=True)  # noqa: E731
            args = (rows, cols, gpot)
            opts = {"soft": True}
        # the first LANE_ROWS rows (and their row potentials) of every lane
        row_args = (0, 2) if name != "ot_ctransform" else (0,)
        sub32 = [t[:, :LANE_ROWS].contiguous() if i in row_args else t
                 for i, t in enumerate(args)]
        got = kern(*args)[:, :LANE_ROWS]
        torch.cuda.synchronize()
        sub64 = [t.double() for t in sub32]
        exact = plain(*sub64)
        plain32 = plain(*sub32)
        terms = plan_grad_terms(*sub64) if name == "ot_plan_grad" else 0.0
        err = float((got.double() - exact).abs().max())
        scale = float(exact.abs().max())
        tol = SOFT_CT_TOL * (1.0 + scale) if soft else REDUCE_RTOL * max(scale, terms)
        ok = bool(torch.isfinite(got).all()) and err <= tol
        row = {"phase": "kernel_parity", "kernel": name, "role": role,
               "shape": [S, k, m, d], **opts,
               "rows": LANE_ROWS, "reference": "plain f64", "max_abs_err": err,
               "max_abs_ref": scale, "terms": terms, "tolerance": tol, "ok": ok,
               "plain_max_abs_err_vs_f64": float((plain32.double() - exact).abs().max()),
               "max_abs_err_vs_plain": float((got - plain32).abs().max())}
        del got, exact, plain32, sub64
        ms = cuda_ms(lambda: kern(*args), MAIN_100K_LAUNCHES)
        plain_ms = cuda_ms(lambda: plain(*args), PLAIN_100K_REPS)
        b_ms, b_by = bound_ms(*ot_work(name, S, k, m, d, **opts))
        row.update(ms=ms, plain_ms=plain_ms, bound_us=1e3 * b_ms, bound_by=b_by)
        row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        if role == "main":
            timing[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} vs the f64 value > {tol}")
        del rows, cols, f, gpot, rhs, args


def ct_rescale_rows():
    """The soft c-transform's lazily moved reference (csrc/ot_ctransform.cu)
    on adversarial rows, against the plain version on the card within
    SOFT_CT_TOL·(1 + max|plain|), at CT_RESCALE_SHAPES:
    - "max last in chunk": the potential of the last column of each of the
      kernel's m-chunks is raised 1000 above the lane's largest, so every
      row's maximum comes last in its chunk, > 1000 (base 2) above the
      reference the row carried to it;
    - "span > 300": potentials rising linearly by 250 along the columns
      (360 in base 2), so the reference climbs through every chunk;
    - "far": every column 1000 away from the rows in each coordinate (C ≈
      3e6), so every term of a naive exp would underflow.
    Emits one row per case and raises on a failed one."""
    import torch

    from dist_svgd_torch.ops import cuda_ot

    for si, (S, k, m, d) in enumerate(CT_RESCALE_SHAPES):
        nsplit, chunk = cuda_ot._split(S, k, m, torch.device("cuda", 0),
                                       cuda_ot._ROWS * cuda_ot._CT_ROWS_PER_THREAD,
                                       cuda_ot._CT_BLOCKS_PER_SM)
        for ci, case in enumerate(("max last in chunk", "span > 300", "far")):
            g = torch.Generator(device="cpu").manual_seed(300 + 3 * si + ci)
            scale = (20.0 / (2 * d)) ** 0.5
            rows = scale * torch.randn(S, k, d, generator=g)
            cols = scale * torch.randn(S, m, d, generator=g)
            p = 4.0 * torch.randn(S, m, generator=g)
            if case == "max last in chunk":
                last = [min(m, (c + 1) * chunk) - 1 for c in range(nsplit)]
                p[:, last] = p.amax() + 1000.0 + torch.rand(S, len(last), generator=g)
            elif case == "span > 300":
                p = torch.linspace(-250.0, 0.0, m).expand(S, m).contiguous()
            else:
                cols = cols + 1000.0
            rows, cols, p = rows.cuda(), cols.cuda(), p.cuda()
            got = cuda_ot.ctransform_reduce_cuda(rows, cols, p, True)
            torch.cuda.synchronize()
            want = cuda_ot.ctransform_reduce_plain(rows, cols, p, True)
            ok, err, tol, scale = ot_check("ot_ctransform", got, want, soft=True)
            emit({"phase": "kernel_parity", "kernel": "ot_ctransform",
                  "role": f"rescale: {case}", "shape": [S, k, m, d], "soft": True,
                  "nsplit": nsplit, "chunk": chunk, "max_abs_err": err,
                  "max_abs_plain": scale, "tolerance": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"ot_ctransform rescale {case} {(S, k, m, d)}: "
                                     f"max|Δ| {err} over tolerance {tol}")


def kernel_profile_row(phase, name, y, x, s, h, calls):
    """One φ kernel's wrapper call on (y, x, s) at bandwidth h: the host's
    enqueue time a call (``calls`` calls without a synchronise) and the
    device time a call by kernel (profile_steps)."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd

    fn = getattr(cuda_svgd, f"{name}_cuda")
    for _ in range(3):
        fn(y, x, s, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(y, x, s, h)
    host_ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    prof = profile_steps(lambda: [fn(y, x, s, h) for _ in range(calls)], calls,
                         phase=phase, top=8)
    prof.pop("top_host_ops_self_ms_per_step")
    row = {key.replace("_per_step", "_per_call").replace("steps", "calls"): value
           for key, value in prof.items()}
    row.update(kernel=name, shape=list(y.shape[:2]) + [x.shape[-2], y.shape[-1]],
               bandwidth=h, host_enqueue_ms_per_call=host_ms)
    return row


def big_d_profile_rows():
    """Each big-d kernel's wrapper call at its main shape and h = 1
    (kernel_profile_row, BIG_D_PROFILE_CALLS calls)."""
    for name, shape in (("phi_big_d", (8, 1250, 10_000, 61)),
                        ("phi_big_d_bf16x3", (8, 1250, 10_000, 55))):
        y, x, s = phi_inputs(*shape, 0)
        emit(kernel_profile_row("big_d_kernel_profile", name, y, x, s, 1.0,
                                BIG_D_PROFILE_CALLS))
        del y, x, s


def wide_d_profile_rows():
    """Each wide-d kernel's wrapper call at the BNN's one lane (h = 1, y = x
    = the driver's initial particles) and at the throughput shape (8 × 1250
    × 10,000, h = 2d), WIDE_D_PROFILE_CALLS calls each (kernel_profile_row),
    with its blocks a cluster."""
    from dist_svgd_torch.models import bnn
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.utils.datasets import UCI_REGRESSION_DIMS

    for name in WIDE_D_KERNELS:
        for role, (S, k, m, d) in (("bnn lane h=1", (1, 500, 500, 753)),
                                   ("throughput", (8, 1250, 10_000, 753))):
            y, x, s = phi_inputs(S, k, m, d, 1)
            h = 2.0 * d
            if role.startswith("bnn"):
                x = bnn.init_particles(0, m, UCI_REGRESSION_DIMS["boston"], device="cuda")
                y, h = x[None].clone(), 1.0
            row = kernel_profile_row("wide_d_kernel_profile", name, y, x, s, h,
                                     WIDE_D_PROFILE_CALLS)
            row.update(role=role, blocks_a_cluster=cuda_svgd.wide_d_slices(name, d)[1])
            emit(row)
            del y, x, s


def profile_steps(run, steps, phase="profile", top=8):
    """Device time by kernel over ``steps`` sampler steps (``run()`` takes
    them), from the CUDA activities of a torch.profiler trace (and that of
    the hand φ kernels, whose names hold ``phi_``), the device's
    busy share of the host wall time of those steps (one stream, so kernels
    do not overlap), the wall time the device idles, and the ``top`` host
    operations by their own CPU time (where that idle time goes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}  # by the first 80 characters of the kernel's name
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(ev.name[:80], (0.0, 0))
            by_name[ev.name[:80]] = (us + ev.time_range.elapsed_us(), count + 1)
    device_us = sum(us for us, _ in by_name.values())
    phi_us = sum(us for name, (us, _) in by_name.items() if "phi_" in name)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    host = sorted(((ev.key, ev.self_cpu_time_total, ev.count) for ev in prof.key_averages()
                   if ev.self_cpu_time_total > 0), key=lambda kv: -kv[1])[:top]
    return {"phase": phase, "steps": steps,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_ms_per_step": device_us / 1e3 / steps if device_us else "not measured",
            "device_busy_share": device_us / wall_us if device_us else "not measured",
            "device_idle_ms_per_step": ((wall_us - device_us) / 1e3 / steps if device_us
                                        else "not measured"),
            "device_ops_per_step": sum(c for _, c in by_name.values()) / steps,
            # the hand φ kernels' own (pre-pass, partial sums, finalize)
            "phi_device_ms_per_step": phi_us / 1e3 / steps if device_us else "not measured",
            "top_kernels_ms_per_step": {name: us / 1e3 / steps
                                        for name, (us, _) in kernels},
            "top_kernel_launches_per_step": {name: c / steps
                                             for name, (_, c) in kernels},
            "top_host_ops_self_ms_per_step": {name[:80]: [us / 1e3 / steps, c / steps]
                                              for name, us, c in host}}


def covertype_phases():
    """The Covertype phases (BASELINE.json config 4, minibatched, through
    ``dist_svgd_torch/experiments/covertype.py``): both φ tiers timed in
    turns, a full run of each, the profile, the bf16 trajectory against
    the plain versions, and a small minibatched reference.  Returns the
    bf16 tier's launch counts of its first timed turn."""
    import numpy as np
    import torch

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.ops import cuda_svgd

    from dist_svgd_torch.experiments import covertype as cov
    from dist_svgd_torch.utils.rng import minibatch_indices

    ct = COVERTYPE
    # the driver's 'auto' resolves to the bf16 tiers on the card; 'cuda' is
    # the exact comparison
    tiers = {"cuda_bf16": "auto", "cuda": "cuda"}
    expect = {"cuda_bf16": phi_counts(phi_big_d_bf16x3=ct["steps"]),
              "cuda": phi_counts(phi_big_d=ct["steps"])}
    ct_rows = {tier: [] for tier in tiers}
    for tier in ("cuda_bf16", "cuda", "cuda", "cuda_bf16"):
        cds, _, info = cov.make_sampler(phi_impl=tiers[tier])
        if info["phi_impl"] != tier:
            raise AssertionError(f"covertype: phi_impl {tiers[tier]!r} resolved to "
                                 f"{info['phi_impl']!r}, not {tier!r}")
        cds.run_steps(ct["warm_steps"], ct["step_size"])
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cds.run_steps(ct["steps"], ct["step_size"])
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launched = dict(cuda_svgd.launch_counts)
        finite = bool(torch.isfinite(cds.particles).all())
        row = {"phase": "covertype", "phi_impl": tier, "turn": len(ct_rows[tier]) + 1,
               "n": info["n_used"], "shards": cds._num_shards, "d": cds.particles.shape[1],
               "batch_size": info["batch_size"], "steps": ct["steps"],
               "ms_per_step": 1e3 * host_s / ct["steps"],
               "updates_per_s": info["n_used"] * ct["steps"] / host_s,
               "launches": launched,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "finite": finite}
        ct_rows[tier].append(row)
        emit(row)
        if not finite or launched != expect[tier]:
            raise AssertionError(f"covertype {tier}: finite={finite} launches={launched}")
        del cds
    launches_ct = ct_rows["cuda_bf16"][0]["launches"]

    # a full run() of each tier: 200 steps, the ensemble test accuracy
    accs = {}
    for tier in tiers:
        final, metrics = cov.run(phi_impl=tiers[tier])
        accs[tier] = metrics["test_acc"]
        emit({"phase": "covertype_run", **metrics,
              "finite": bool(np.isfinite(final).all())})
        if metrics["phi_impl"] != tier or not np.isfinite(final).all():
            raise AssertionError(f"covertype run {tier}: {metrics}")
    gap = abs(accs["cuda_bf16"] - accs["cuda"])
    emit({"phase": "covertype_accuracy", "test_acc": accs, "gap": gap,
          "bound": CT_ACC_TOL, "ok": gap <= CT_ACC_TOL,
          "ms_per_step": {t: [r["ms_per_step"] for r in rows] for t, rows in ct_rows.items()}})
    if not gap <= CT_ACC_TOL:
        raise AssertionError(f"covertype accuracy: tiers {accs} differ by more than "
                             f"{CT_ACC_TOL}")

    # ---- 11b. where a Covertype step's time goes (torch.profiler) -----------
    pds, _, _ = cov.make_sampler()
    pds.run_steps(ct["warm_steps"], ct["step_size"])
    emit(profile_steps(lambda: pds.run_steps(ct["profile_steps"], ct["step_size"]),
                       ct["profile_steps"], phase="covertype_profile"))
    del pds

    # ---- 11c. Covertype trajectory: bf16 kernels vs their plain versions ---
    runs = {}
    indices = {}
    for impl in ("cuda_bf16", "torch_bf16"):
        tds, _, info = cov.make_sampler(phi_impl=impl)
        if not indices:  # the same minibatch indices for both, through the seam
            indices = {t: minibatch_indices(1234, t, tds._num_shards, tds._rows_per_shard,
                                            info["batch_size"], "cuda")
                       for t in range(1, ct["trajectory_steps"] + 1)}
        tds._batch_index_seam = indices.__getitem__
        tds.run_steps(ct["trajectory_steps"], ct["step_size"])
        runs[impl] = tds.particles
        del tds
    dev = float((runs["cuda_bf16"] - runs["torch_bf16"]).abs().max())
    rel = dev / float(runs["torch_bf16"].abs().max())
    emit({"phase": "covertype_trajectory", "steps": ct["trajectory_steps"],
          "max_abs_dev": dev, "rel_dev": rel, "bound": TRAJ_RTOL, "ok": rel <= TRAJ_RTOL})
    if not rel <= TRAJ_RTOL:
        raise AssertionError(f"covertype trajectory: {rel} > {TRAJ_RTOL}")
    del runs

    # ---- 11d. small-input reference with minibatches: card f32 vs CPU f64 --
    from dist_svgd_torch.models.logreg import logreg_likelihood, logreg_prior

    rng = np.random.default_rng(9)
    worst = 0.0
    for dd in (3, 12):
        parts = rng.normal(size=(64, dd))
        xr = rng.normal(size=(48, dd - 1))
        tr_ = np.where(rng.normal(size=48) > 0, 1.0, -1.0)
        idx = {t: np.stack([rng.permutation(12)[:5] for _ in range(4)]) for t in (1, 2, 3)}
        for exch_p, exch_s in ((True, False), (True, True), (False, False)):
            out = {}
            for dev_name, impl, dtype in (("cuda", "cuda", np.float32),
                                          ("cpu", "torch", np.float64)):
                r = DistSampler(4, logreg_likelihood, None, parts.astype(dtype),
                                data=(xr, tr_), exchange_particles=exch_p,
                                exchange_scores=exch_s, include_wasserstein=False,
                                batch_size=5, log_prior=logreg_prior,
                                phi_impl=impl, device=dev_name)
                r._batch_index_seam = idx.__getitem__
                r.run_steps(3, 0.05)
                out[dev_name] = r.particles.double().cpu()
            rel = float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max())
            worst = max(worst, rel)
    emit({"phase": "small_reference_minibatch", "modes": 3, "dims": [3, 12],
          "batch_size": 5, "max_rel_dev": worst, "bound": SMALL_RTOL,
          "ok": worst <= SMALL_RTOL})
    if not worst <= SMALL_RTOL:
        raise AssertionError(f"small minibatch reference: {worst} > {SMALL_RTOL}")
    return launches_ct


def device_profile(run, top=6):
    """Device time and launches by kernel of ``run()`` from a CUDA-only
    torch.profiler trace: the light form of :func:`profile_steps` for runs
    of tens of thousands of launches (a full-width Gauss-Seidel step),
    whose host-op trace takes minutes to read back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(ev.name[:80], (0.0, 0))
            by_name[ev.name[:80]] = (us + ev.time_range.elapsed_us(), count + 1)
    device_us = sum(us for us, _ in by_name.values())
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"profiled_wall_ms": wall_us / 1e3,
            "device_ms": device_us / 1e3 if device_us else "not measured",
            "device_ops": sum(c for _, c in by_name.values()),
            "phi_device_ms": (sum(us for name, (us, _) in by_name.items() if "phi_" in name)
                              / 1e3 if device_us else "not measured"),
            "top_kernels_ms": {name: us / 1e3 for name, (us, _) in kernels},
            "top_kernel_launches": {name: c for name, (_, c) in kernels}}


def covertype_nproc1_phase():
    """Covertype (BASELINE.json config 4) through the single-device
    ``Sampler`` (``--nproc 1``): the driver's sampler, 10,000 particles
    against each other on one lane, B = 256 rows a step; the driver's
    ``'auto'`` is the bf16 tier on the card."""
    import torch

    from dist_svgd_torch.experiments import covertype as cov
    from dist_svgd_torch.models.logreg import ensemble_test_accuracy
    from dist_svgd_torch.ops import cuda_svgd

    c = COVERTYPE_NPROC1
    step = COVERTYPE["step_size"]
    sampler, (x_test, t_test), info = cov.make_sampler(nproc=1)
    n = info["n_used"]
    warm, _ = sampler.run(n, c["warm_steps"], step, record=False,
                          initial_particles=info["init"])
    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    t0 = time.perf_counter()
    final, _ = sampler.run(n, c["steps"], step, record=False, initial_particles=warm,
                           step_offset=c["warm_steps"])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launched = dict(cuda_svgd.launch_counts)
    finite = bool(torch.isfinite(final).all())
    ok = (finite and info["phi_impl"] == "cuda_bf16"
          and launched == phi_counts(phi_big_d_bf16x3=c["steps"]))
    emit({"phase": "covertype_nproc1", "n": n, "d": final.shape[1],
          "batch_size": info["batch_size"], "phi_impl": info["phi_impl"],
          "steps": c["steps"], "ms_per_step": 1e3 * host_s / c["steps"],
          "updates_per_s": n * c["steps"] / host_s, "launches": launched,
          "test_accuracy": float(ensemble_test_accuracy(final, x_test, t_test)),
          "finite": finite, "ok": ok})
    if not ok:
        raise AssertionError(f"covertype nproc1: finite={finite} phi_impl="
                             f"{info['phi_impl']} launches={launched}")


def bnn_phases():
    """The BNN phases (BASELINE.json config 5, d = 753, through
    ``dist_svgd_torch/experiments/bnn.py``).  Returns the launch counts of
    the full default run (``phi_wide_d``) and of the bf16 run
    (``phi_wide_d_bf16x3``)."""
    import numpy as np
    import torch

    from dist_svgd_torch.experiments import bnn as drv
    from dist_svgd_torch.models import bnn
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.sampler import Sampler
    from dist_svgd_torch.utils.datasets import load_uci_regression
    from dist_svgd_torch.utils.rng import minibatch_indices

    b = BNN
    sp = load_uci_regression("boston", 0)
    n_features = sp.x_train.shape[1]
    baseline = float(np.sqrt(np.mean((sp.y_test - sp.y_mean) ** 2)))

    def driven(phase, expect, **kw):
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        final, m = drv.run(**kw)
        torch.cuda.synchronize()
        launched = dict(cuda_svgd.launch_counts)
        finite = bool(np.isfinite(final).all() and np.isfinite(m["test_rmse"])
                      and np.isfinite(m["test_loglik"]))
        niter = m["niter"]
        row = {"phase": phase, **m,
               "ms_per_step": 1e3 * m["wall_s"] / niter if niter else None,
               "launches": launched, "finite": finite}
        ok = finite and (expect is None or launched == expect)
        return row, ok

    # ---- the driver at its full defaults (h = 1, the exact tier) -----------
    row, ok = driven("bnn", phi_counts(phi_wide_d=b["steps"]))
    launches_bnn = row["launches"]
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"bnn: {row}")

    # ---- the per-step median bandwidth, against the baselines --------------
    untrained, ok0 = driven("bnn_untrained", None, niter=0)
    row, ok = driven("bnn_median_step", phi_counts(phi_wide_d=b["steps"]),
                     bandwidth="median_step")
    # the ungated linear yardstick: least squares with an intercept
    xt = np.hstack([sp.x_train, np.ones((sp.x_train.shape[0], 1))]).astype(np.float64)
    coef = np.linalg.lstsq(xt, sp.y_train.astype(np.float64), rcond=None)[0]
    pred = np.hstack([sp.x_test, np.ones((sp.x_test.shape[0], 1))]) @ coef
    linear = float(np.sqrt(np.mean((pred * sp.y_std + sp.y_mean - sp.y_test) ** 2)))
    beats = row["test_rmse"] < baseline and row["test_rmse"] < untrained["test_rmse"]
    ok = ok and ok0 and beats
    emit({**row, "mean_baseline_rmse": baseline, "untrained_rmse": untrained["test_rmse"],
          "linear_fit_rmse": linear, "beats_baselines": beats, "ok": ok})
    if not ok:
        raise AssertionError(f"bnn median_step: {row} baseline {baseline} "
                             f"untrained {untrained['test_rmse']}")

    # ---- the bf16x3 tier and the 8-shard DistSampler ------------------------
    row, ok = driven("bnn_bf16", phi_counts(phi_wide_d_bf16x3=b["bf16_steps"]),
                     phi_impl="cuda_bf16", niter=b["bf16_steps"])
    launches_bf16 = row["launches"]
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"bnn bf16: {row}")
    row, ok = driven("bnn_dist", phi_counts(phi_wide_d=b["dist_steps"]),
                     nproc=b["dist_shards"], nparticles=b["dist_particles"],
                     niter=b["dist_steps"])
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"bnn dist: {row}")

    # ---- where a BNN step's time goes (torch.profiler) ----------------------
    likelihood, prior = bnn.make_bnn_split(n_features)
    d = bnn.num_params(n_features)
    data = (torch.as_tensor(sp.x_train).cuda(), torch.as_tensor(sp.y_train).cuda())
    init = bnn.init_particles(0, 500, n_features, device="cuda")

    def sampler(**kw):
        return Sampler(d, likelihood, data=data, batch_size=100, log_prior=prior, **kw)

    ps = sampler()
    ps.run(500, 3, 1e-3, record=False, initial_particles=init)
    emit(profile_steps(
        lambda: ps.run(500, b["profile_steps"], 1e-3, record=False, initial_particles=init),
        b["profile_steps"], phase="bnn_profile"))

    # ---- 20-step trajectories: the hand kernels vs their plain versions -----
    idx = {t: minibatch_indices(5, t, 1, sp.x_train.shape[0], 100, "cuda")[0]
           for t in range(b["trajectory_steps"])}
    devs = {}
    for kern_impl, plain_impl in (("cuda", "torch"), ("cuda_bf16", "torch_bf16")):
        runs = {}
        for impl in (kern_impl, plain_impl):
            ts = sampler(kernel="median_step", phi_impl=impl)
            ts._batch_index_seam = idx.__getitem__
            runs[impl], _ = ts.run(500, b["trajectory_steps"], 1e-3, record=False,
                                   initial_particles=init)
        dev = float((runs[kern_impl] - runs[plain_impl]).abs().max())
        devs[kern_impl] = dev / float(runs[plain_impl].abs().max())
    ok = all(v <= TRAJ_RTOL for v in devs.values())
    emit({"phase": "bnn_trajectory", "steps": b["trajectory_steps"], "kernel": "median_step",
          "rel_dev": devs, "bound": TRAJ_RTOL, "ok": ok})
    if not ok:
        raise AssertionError(f"bnn trajectory: {devs} > {TRAJ_RTOL}")

    # ---- small reference: the card (f32, 'cuda') vs the CPU (f64, 'torch') --
    slik, sprior = bnn.make_bnn_split(n_features, b["small_hidden"])
    sd = bnn.num_params(n_features, b["small_hidden"])
    sparts = bnn.init_particles(3, b["small_n"], n_features, b["small_hidden"],
                                dtype=torch.float64)
    rows_n = sp.x_train.shape[0]
    rng = np.random.default_rng(11)
    sidx = {t: rng.permutation(rows_n)[:b["small_batch"]] for t in range(b["small_steps"])}
    worst = {}
    for label, kw in (("full", {}), ("minibatch", {"batch_size": b["small_batch"]}),
                      ("median_step", {"kernel": "median_step"}),
                      ("minibatch median_step", {"batch_size": b["small_batch"],
                                                 "kernel": "median_step"})):
        out = {}
        for dev_name, impl, dtype in (("cuda", "cuda", torch.float32),
                                      ("cpu", "torch", torch.float64)):
            r = Sampler(sd, slik, data=(sp.x_train, sp.y_train), log_prior=sprior,
                        phi_impl=impl, device=dev_name, **kw)
            r._batch_index_seam = sidx.__getitem__
            out[dev_name], _ = r.run(b["small_n"], b["small_steps"], 1e-3, record=False,
                                     initial_particles=sparts.to(dtype))
        c, h = out["cuda"].double().cpu(), out["cpu"]
        worst[label] = float((c - h).abs().max() / h.abs().max())
    ok = all(v <= SMALL_RTOL for v in worst.values())
    emit({"phase": "small_reference_sampler", "d": sd, "n": b["small_n"],
          "steps": b["small_steps"], "max_rel_dev": worst, "bound": SMALL_RTOL, "ok": ok})
    if not ok:
        raise AssertionError(f"small sampler reference: {worst} > {SMALL_RTOL}")
    return launches_bnn, launches_bf16


def gs_probe_rows():
    """The φ kernels at the shapes the reference's entry points give them
    (GS_PROBE_CASES): the Gauss–Seidel probe, one row a lane ``(S, 1, m,
    d)`` against each lane's own view ``(S, m, d)``, the row being one of
    the view's (a self-pair at the drivers' h = 1), and the GMM's d = 1
    lanes, y = x.  Each is held against the plain version and printed
    beside the float64 φ; the d > 8 rows hold against the float64 φ (the
    float32 plain version's y² + x² − 2·y·x does not cancel to 0 on the
    self-pair, the kernel's pre-pass does), the others against the plain
    version, within KERNEL_RTOL of the reference's largest value.  Every
    row is timed beside its bound; raises on a failed row."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.ops.kernels import RBF
    from dist_svgd_torch.ops.svgd import phi

    fns = {"phi_small_d": (cuda_svgd.phi_small_d_cuda, cuda_svgd.phi_small_d_plain),
           "phi_big_d": (cuda_svgd.phi_big_d_cuda, cuda_svgd.phi_big_d_plain)}
    for seed, (name, (S, k, m, d), role) in enumerate(GS_PROBE_CASES, start=GS_PROBE_SEED):
        kern, plain = fns[name]
        g = torch.Generator(device="cpu").manual_seed(seed)
        if k == m:  # a Jacobi lane of the Sampler: y is x
            x = torch.randn(m, d, generator=g).cuda()
            y = x[None].clone()
        else:  # the GS probe: row r of each lane's own view
            x = torch.randn(S, m, d, generator=g).cuda()
            rows = torch.randint(0, m, (S,), generator=g).cuda()
            y = x[torch.arange(S, device=x.device), rows][:, None].contiguous()
        s = torch.randn(S, m, d, generator=g).cuda()
        h = 1.0
        got = kern(y, x, s, h)
        torch.cuda.synchronize()
        want = plain(y, x, s, h)
        exact = phi(y.double(), x.double(), s.double(), RBF(h))
        vs_f64 = float((got.double() - exact).abs().max())
        vs_plain = float((got - want).abs().max())
        if d > cuda_svgd.SMALL_D:
            err, scale, reference = vs_f64, float(exact.abs().max()), "phi f64"
        else:
            err, scale, reference = vs_plain, float(want.abs().max()), "plain"
        tol = KERNEL_RTOL * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        b_ms, b_by = bound_ms(*phi_work(name, S, k, m, d, x.numel()))
        row = {"phase": "kernel_parity", "kernel": name, "role": role, "shape": [S, k, m, d],
               "bandwidth": h, "reference": reference, "max_abs_err": err,
               "max_abs_ref": scale, "tolerance": tol, "ok": ok,
               "max_abs_err_vs_f64": vs_f64, "max_abs_err_vs_plain": vs_plain,
               "plain_max_abs_err_vs_f64": float((want.double() - exact).abs().max()),
               "ms": cuda_ms(lambda: kern(y, x, s, h), TIMED_LAUNCHES),
               "plain_ms": cuda_ms(lambda: plain(y, x, s, h), OTHER_LAUNCHES),
               "bound_us": 1e3 * b_ms, "bound_by": b_by,
               "m_splits": cuda_svgd.split_count(name, S, k, m, x.device)}
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} vs the {reference} > {tol}")


def _f64_driver_init():
    """The logreg driver's initial draw, in float64: the same numbers as
    its float32 draw (drawn in float32, then widened), so that a CPU
    float64 run starts where the card's run starts."""
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    return lambda *a, **k: init_particles_per_shard(*a, **k).double()


def _driver_reference(drv, *args, **kw):
    """The logreg driver's snapshots on the CPU in float64 with the plain
    φ: the reference a card run of the same configuration is held
    against."""
    real = drv.init_particles_per_shard
    drv.init_particles_per_shard = _f64_driver_init()
    try:
        return drv.run_snapshots(*args, phi_impl="torch", device="cpu", **kw)[1]
    finally:
        drv.init_particles_per_shard = real


def _snapshots_dev(card, ref):
    """max|Δ| / max|ref| over every rank's snapshots."""
    import numpy as np

    return (max(float(np.abs(c - r).max()) for c, r in zip(card, ref))
            / max(float(np.abs(r).max()) for r in ref))


def logreg_phases():
    """The logreg driver (``dist_svgd_torch/experiments/logreg.py``,
    ``run_snapshots``: the card has no pandas for its pickles): BASELINE
    config 1 (``logreg_driver``), the reference's ``grid.sh`` sweep shape
    (``logreg_grid``), the full-width recorded run (``logreg_north_star
    _record``) and one full-width Gauss–Seidel step (``logreg_gs_full
    _width``).  Raises on a failed phase."""
    import torch

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.experiments import logreg as drv
    from dist_svgd_torch.models.logreg import ensemble_test_accuracy, logreg_logp
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.utils import history
    from dist_svgd_torch.utils.datasets import load_benchmark
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    def timed(fn):
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(cuda_svgd.launch_counts)

    # ---- config 1: banana, 100 particles, one shard, partitions ----------
    c = LOGREG_DRIVER
    args = (1, c["dataset"], c["fold"], c["n"], c["steps"], c["step_size"], "partitions",
            False)
    drv.run_snapshots(1, c["dataset"], c["fold"], c["n"], 2, c["step_size"], "partitions",
                      False)  # warm
    (sampler, blocks), host_s, launched = timed(lambda: drv.run_snapshots(*args))
    rel = _snapshots_dev(blocks, _driver_reference(drv, *args))
    fold = load_benchmark(c["dataset"], c["fold"])
    acc = float(ensemble_test_accuracy(torch.as_tensor(blocks[0][-1]),
                                       torch.as_tensor(fold.x_test),
                                       torch.as_tensor(fold.t_test.reshape(-1))))
    ok = launched == phi_counts(phi_small_d=c["steps"]) and rel <= SMALL_RTOL
    emit({"phase": "logreg_driver", "dataset": c["dataset"], "fold": c["fold"], "n": c["n"],
          "shards": 1, "exchange": "partitions", "update_rule": "jacobi",
          "steps": c["steps"], "ms_per_step": 1e3 * host_s / c["steps"],
          "launches": launched, "test_accuracy": acc, "max_rel_dev_vs_cpu_f64": rel,
          "bound": SMALL_RTOL, "ok": ok})
    if not ok:
        raise AssertionError(f"logreg driver: launches={launched} rel={rel}")

    # ---- the grid.sh shape: 50 particles on 4 and 8 shards ----------------
    gr = LOGREG_GRID
    t_phase = time.perf_counter()
    rows, worst = [], {False: 0.0, True: 0.0}
    for S in gr["shards"]:
        per = gr["n"] // S
        for exchange in ("partitions", "all_particles", "all_scores"):
            for w2 in (False, True):
                for rule in ("jacobi", "gauss_seidel"):
                    args = (S, "banana", 42, gr["n"], gr["steps"], gr["step_size"], exchange,
                            w2, "lp", rule)
                    (_, blocks), host_s, launched = timed(lambda: drv.run_snapshots(*args))
                    rel = _snapshots_dev(blocks, _driver_reference(drv, *args))
                    expect = gr["steps"] * (per if rule == "gauss_seidel" else 1)
                    bound = W2_SMALL_RTOL if w2 else SMALL_RTOL
                    ok = launched == phi_counts(phi_small_d=expect) and rel <= bound
                    worst[w2] = max(worst[w2], rel)
                    rows.append({"shards": S, "exchange": exchange, "w2": w2,
                                 "update_rule": rule,
                                 "ms_per_step": 1e3 * host_s / gr["steps"],
                                 "phi_small_d": launched["phi_small_d"], "expect": expect,
                                 "max_rel_dev_vs_cpu_f64": rel, "ok": ok})
    ok = all(r["ok"] for r in rows)
    emit({"phase": "logreg_grid", "dataset": "banana", "fold": 42, "n": gr["n"],
          "steps": gr["steps"], "step_size": gr["step_size"], "h": drv.W2_H, "runs": rows,
          "max_rel_dev": {"no_w2": worst[False], "lp_w2": worst[True]},
          "bound": {"no_w2": SMALL_RTOL, "lp_w2": W2_SMALL_RTOL},
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise AssertionError(f"logreg grid: {[r for r in rows if not r['ok']]}")

    # ---- full width, recorded: splice, 10,000 particles, 8 shards ---------
    rc = LOGREG_RECORD
    S, n = rc["shards"], rc["n"]
    args = (S, rc["dataset"], rc["fold"], n, rc["steps"], rc["step_size"], "partitions",
            False)
    sfold = load_benchmark(rc["dataset"], rc["fold"])
    d = 1 + sfold.x_train.shape[1]
    init = init_particles_per_shard(0, n, d, S)

    def unrecorded():
        ds = DistSampler(S, logreg_logp, None, init,
                         data=(sfold.x_train, sfold.t_train.reshape(-1)),
                         exchange_particles=False, exchange_scores=False,
                         include_wasserstein=False, device="cuda")
        return ds, ds.run_steps(rc["steps"], rc["step_size"])

    unrecorded()  # warm
    (plain_ds, plain_final), plain_s, _ = timed(unrecorded)
    (sampler, blocks), host_s, launched = timed(lambda: drv.run_snapshots(*args))
    final = plain_final.cpu().numpy().reshape(S, n // S, d)
    same = all((blocks[r][-1] == final[plain_ds.owned_block_index(r)]).all()
               for r in range(S))
    stats = sampler.last_run_stats
    ok = same and launched == phi_counts(phi_big_d=rc["steps"])
    emit({"phase": "logreg_north_star_record", "dataset": rc["dataset"], "fold": rc["fold"],
          "n": n, "shards": S, "d": d, "exchange": "partitions", "steps": rc["steps"],
          "ms_per_step": 1e3 * host_s / rc["steps"],
          "ms_per_step_unrecorded": 1e3 * plain_s / rc["steps"],
          "record_chunk_steps": history.record_chunk_steps(n, d),
          "record_chunks_to_host": stats["record_chunks_to_host"],
          "history_mb": sum(b.nbytes for b in blocks) / 2 ** 20,
          "launches": launched, "final_equals_unrecorded": bool(same), "ok": ok})
    if not ok:
        raise AssertionError(f"logreg record: same={same} launches={launched}")

    # ---- one Gauss–Seidel step at full width ------------------------------
    gs = LOGREG_GS
    S, n = gs["shards"], gs["n"]
    for dataset, fold_id, kernel in (("banana", 42, "phi_small_d"), ("splice", 1, "phi_big_d")):
        t_phase = time.perf_counter()
        f = load_benchmark(dataset, fold_id)
        d = 1 + f.x_train.shape[1]
        start = init_particles_per_shard(0, n, d, S)

        def gs_sampler(impl, dtype=torch.float32):
            return DistSampler(S, logreg_logp, None, start.to(dtype),
                               data=(f.x_train, f.t_train.reshape(-1)),
                               exchange_particles=True, exchange_scores=False,
                               include_wasserstein=False, update_rule="gauss_seidel",
                               phi_impl=impl, device="cuda")

        ds = gs_sampler("auto")
        # the step under a CUDA-only trace, whose host cost is nil (6915.4
        # against 6914.1 ms unprofiled, measured on one H100)
        prof, _, launched = timed(lambda: device_profile(lambda: ds.make_step(gs["step_size"])))
        got = ds.particles.clone()
        ref = gs_sampler("torch").make_step(gs["step_size"])
        scale = float(ref.abs().max())
        rel = float((got - ref).abs().max()) / scale
        row = {"phase": "logreg_gs_full_width", "dataset": dataset, "n": n, "shards": S,
               "d": d, "exchange": "all_particles", "step_size": gs["step_size"],
               "ms_per_step": prof.pop("profiled_wall_ms"), "launches": launched,
               "rows_per_step": n // S, "max_rel_dev_vs_torch": rel}
        ok = launched == phi_counts(**{kernel: n // S}) and rel <= TRAJ_RTOL
        if d > cuda_svgd.SMALL_D:  # the self-pair: hold both against float64
            exact = gs_sampler("torch", torch.float64).make_step(gs["step_size"])
            row["max_rel_dev_vs_f64"] = float((got.double() - exact).abs().max()) / scale
            row["torch_max_rel_dev_vs_f64"] = float((ref.double() - exact).abs().max()) / scale
            ok = ok and row["max_rel_dev_vs_f64"] <= TRAJ_RTOL
        row.update({f"{k}_per_step": v for k, v in prof.items()})
        row.update(seconds=time.perf_counter() - t_phase, bound=TRAJ_RTOL, ok=ok)
        emit(row)
        if not ok:
            raise AssertionError(f"logreg GS {dataset}: launches={launched} rel={rel}")


def gmm_phase():
    """The GMM driver's runs (``dist_svgd_torch/experiments/gmm.py``,
    BASELINE config 2) through ``Sampler.run``: the driver's 50 particles
    and config 2's 256, 500 steps of 1.0 each, Jacobi, then a short
    Gauss–Seidel run, which by JAX's design calls the plain φ and launches
    no kernel.  Each Jacobi run is held against the same run on the CPU in
    float64 with the plain φ (TRAJ_RTOL: 500 steps of float32 rounding)
    and its final moments against the mixture's (mean 0, std ~2.24).
    Raises on a failed run."""
    import torch

    from dist_svgd_torch.experiments import gmm as drv
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.utils.rng import init_particles

    rows = []
    for n in GMM["n"]:
        init = init_particles(drv.SEED, n, drv.D)
        drv.make_sampler("cuda").run(n, 2, drv.STEP_SIZE, initial_particles=init.cuda())
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        t0 = time.perf_counter()
        final, hist = drv.make_sampler("cuda").run(n, drv.NUM_ITER, drv.STEP_SIZE,
                                                   initial_particles=init.cuda())
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launched = dict(cuda_svgd.launch_counts)
        ref, _ = drv.make_sampler("cpu", phi_impl="torch").run(
            n, drv.NUM_ITER, drv.STEP_SIZE, initial_particles=init.double(), record=False)
        rel = float((final.cpu().double() - ref).abs().max() / ref.abs().max())
        mean, std = float(final.mean()), float(final.std(unbiased=False))
        ok = (launched == phi_counts(phi_small_d=drv.NUM_ITER) and rel <= TRAJ_RTOL
              and tuple(hist.shape) == (drv.NUM_ITER + 1, n, 1)
              and abs(mean) < 0.5 and 1.5 < std < 3.0)
        rows.append(ok)
        emit({"phase": "gmm", "n": n, "d": drv.D, "update_rule": "jacobi",
              "steps": drv.NUM_ITER, "step_size": drv.STEP_SIZE,
              "ms_per_step": 1e3 * host_s / drv.NUM_ITER, "launches": launched,
              "final_mean": mean, "final_std": std, "truth": {"mean": 0.0, "std": 2.24},
              "max_rel_dev_vs_cpu_f64": rel, "bound": TRAJ_RTOL, "ok": ok})
    init = init_particles(drv.SEED, drv.N, drv.D)
    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    t0 = time.perf_counter()
    final, _ = drv.make_sampler("cuda", update_rule="gauss_seidel").run(
        drv.N, GMM["gs_steps"], drv.STEP_SIZE, initial_particles=init.cuda(), record=False)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launched = dict(cuda_svgd.launch_counts)
    ok = launched == phi_counts() and bool(torch.isfinite(final).all())
    rows.append(ok)
    emit({"phase": "gmm", "n": drv.N, "d": drv.D, "update_rule": "gauss_seidel",
          "steps": GMM["gs_steps"], "ms_per_step": 1e3 * host_s / GMM["gs_steps"],
          "launches": launched, "final_mean": float(final.mean()),
          "final_std": float(final.std(unbiased=False)), "ok": ok})
    if not all(rows):
        raise AssertionError(f"gmm: {rows}")


def autotune_phase():
    """The autotune tool (``python -m dist_svgd_torch.tools.cuda_autotune``)
    in-process on short chains: its default mode must launch the no-exp
    probe and the exact small-d kernel and print a finite exp share, its
    ``--big-d`` mode both big-d tiers.  Returns the default mode's launch
    counts (the probe's main path)."""
    import math

    import torch

    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.tools import cuda_autotune

    rows = {}
    for mode, want in (("default", ("phi_small_d_noexp", "phi_small_d", "phi_small_d_bf16")),
                       ("--big-d", ("phi_big_d", "phi_big_d_bf16x3"))):
        argv = ["--iters", str(AUTOTUNE_ITERS)] + ([mode] if mode != "default" else [])
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        t0 = time.perf_counter()
        out = cuda_autotune.main(argv)
        torch.cuda.synchronize()
        launched = dict(cuda_svgd.launch_counts)
        errs = [v for key, v in out.items() if key.endswith("_err")]
        ok = (all(launched[name] > 0 for name in want)
              and all(math.isfinite(v) for v in errs)
              and (mode != "default" or (math.isfinite(out["exp_share"])
                                         and math.isfinite(out["exp_share_device"]))))
        rows[mode] = launched
        emit({"phase": "autotune", "mode": mode, "iters": AUTOTUNE_ITERS,
              "seconds": time.perf_counter() - t0, "launches": launched, **out, "ok": ok})
        if not ok:
            raise AssertionError(f"autotune {mode}: launches={launched} out={out}")
    return rows["default"]


def auto_gates_phase():
    """The φ policy's lines.  Each ``'auto'`` gate at its committed value:
    one rung below it the plain φ runs (no launch; it is ``ops.svgd.phi``),
    at it the kernel — at a committed 0 (no gate) one pair launches the
    kernel; then the same gate patched to PATCHED_GATE, so that both sides
    run on the card whatever the committed value.  Past
    ``TORCH_BLOCKWISE_MIN_PAIRS`` (the 100k lanes) and past a line patched
    low (the 10k lanes) ``'torch'`` runs ``phi_blockwise``: at the 10k lanes
    it is held against the one-shot ``phi``; at the 100k lanes, where the
    one-shot Gram is 40 GB, against the one-shot ``phi`` in float64 on the
    first LANE_ROWS rows of a lane (rows are independent)."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.ops.kernels import RBF
    from dist_svgd_torch.ops.svgd import phi

    def lane_shape(pairs):
        m = 1 << ((pairs.bit_length()) // 2)
        return pairs // m, m

    for gate, d in (("CUDA_MIN_PAIRS", 3), ("CUDA_MIN_PAIRS_BIG_D", 55),
                    ("CUDA_MIN_PAIRS_BIG_D", 753)):
        committed = getattr(cuda_svgd, gate)
        h = 1.0 if d <= cuda_svgd.SMALL_D else 2.0 * d
        name = cuda_svgd.kernel_for(d)
        for case, line in (("committed", committed), ("patched", PATCHED_GATE)):
            sides = {}
            setattr(cuda_svgd, gate, line)
            try:
                for side, pairs in (("below", line // 2), ("at", max(line, 1))):
                    if pairs == 0:  # no gate: nothing lies below it
                        continue
                    k, m = lane_shape(pairs)
                    y, x, s = phi_inputs(1, k, m, d, 7)
                    fn = cuda_svgd.resolve_phi_fn(RBF(h), "auto")
                    torch.cuda.synchronize()
                    cuda_svgd.reset_launch_counts()
                    got = fn(y, x, s)
                    torch.cuda.synchronize()
                    launched = dict(cuda_svgd.launch_counts)
                    want = phi(y, x, s, RBF(h))
                    err = float((got - want).abs().max())
                    tol = KERNEL_RTOL * float(want.abs().max())
                    sides[side] = {"shape": [1, k, m, d], "pairs": k * m,
                                   "launches": launched[name],
                                   "max_abs_err_vs_torch_phi": err}
                    expect = phi_counts() if side == "below" else phi_counts(**{name: 1})
                    if launched != expect or not err <= tol:
                        raise AssertionError(
                            f"auto gate {gate}={line} d={d} {side}: {sides[side]}")
            finally:
                setattr(cuda_svgd, gate, committed)
            emit({"phase": "auto_gates", "gate": gate, "case": case, "line": line, "d": d,
                  "kernel": name, **sides, "ok": True})

    # 'torch' past the blockwise line (BLOCKWISE_CASES); the spy counts the
    # policy's calls of phi_blockwise
    calls = []
    orig_blockwise = cuda_svgd.phi_blockwise
    orig_line = cuda_svgd.TORCH_BLOCKWISE_MIN_PAIRS

    def spy(*args, **kw):
        calls.append(1)
        return orig_blockwise(*args, **kw)

    cuda_svgd.phi_blockwise = spy
    try:
        for label, (S, k, m, d), line in BLOCKWISE_CASES:
            line = orig_line if line is None else line
            cuda_svgd.TORCH_BLOCKWISE_MIN_PAIRS = line
            y, x, s = phi_inputs(S, k, m, d, 8)
            calls.clear()
            t0 = time.perf_counter()
            got = cuda_svgd.resolve_phi_fn(RBF(1.0), "torch")(y, x, s)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            extra = {}
            if label == "committed line":
                rows = slice(0, LANE_ROWS)
                want = phi(y[:1, rows].double(), x.double(), s[:1].double(), RBF(1.0))
                got = got[:1, rows].double()
                extra = {"rows": LANE_ROWS}
            else:
                want = phi(y, x, s, RBF(1.0))
            err = float((got - want).abs().max())
            tol = KERNEL_RTOL * float(want.abs().max())
            ok = calls == [1] and bool(torch.isfinite(got).all()) and err <= tol
            emit({"phase": "auto_gates", "gate": "TORCH_BLOCKWISE_MIN_PAIRS", "case": label,
                  "line": line, "shape": [S, k, m, d], "pairs": S * k * m,
                  "blockwise_calls": len(calls), "seconds": seconds,
                  "reference": "phi f64" if extra else "phi", "max_abs_err": err,
                  "tolerance": tol, **extra, "ok": ok})
            if not ok:
                raise AssertionError(f"blockwise {label}: calls={calls} err={err} > {tol}")
            del y, x, s, got, want
    finally:
        cuda_svgd.phi_blockwise = orig_blockwise
        cuda_svgd.TORCH_BLOCKWISE_MIN_PAIRS = orig_line


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.models import bnn
    from dist_svgd_torch.models.logreg import ensemble_test_accuracy, logreg_logp
    from dist_svgd_torch.ops import _build, cuda_ot, cuda_svgd
    from dist_svgd_torch.ops.kernels import RBF, median_bandwidth
    from dist_svgd_torch.ops.svgd import phi
    from dist_svgd_torch.utils.datasets import UCI_REGRESSION_DIMS, load_benchmark
    from dist_svgd_torch.utils.platform import resolve_device
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    t_start = time.perf_counter()
    resolve_device(None)  # pins TF32 off for the plain versions' matmuls

    # ---- 1. device -------------------------------------------------------
    card = smi("name,power.limit")
    print(card, flush=True)
    nvcc_version = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvcc": nvcc_version})

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": " ".join(_build.NVCC_FLAGS),
          "sources": {name: {"path": str(r.path.name), "seconds": r.seconds,
                             "cached": r.cached,
                             "ptxas": [ln.strip() for ln in r.log.splitlines()
                                       if "registers" in ln or "spill" in ln]}
                      for name, r in built.items()}})

    # ---- 3. kernel parity and timing -------------------------------------
    kernel_fns = {
        "phi_small_d": (cuda_svgd.phi_small_d_cuda, cuda_svgd.phi_small_d_plain),
        "phi_big_d": (cuda_svgd.phi_big_d_cuda, cuda_svgd.phi_big_d_plain),
        "phi_small_d_bf16": (cuda_svgd.phi_small_d_bf16_cuda,
                             cuda_svgd.phi_small_d_bf16_plain),
        "phi_big_d_bf16x3": (cuda_svgd.phi_big_d_bf16x3_cuda,
                             cuda_svgd.phi_big_d_bf16x3_plain),
        "phi_wide_d": (cuda_svgd.phi_wide_d_cuda, cuda_svgd.phi_big_d_plain),
        "phi_wide_d_bf16x3": (cuda_svgd.phi_wide_d_bf16x3_cuda,
                              cuda_svgd.phi_big_d_bf16x3_plain),
        # the probe takes no bandwidth (h = 1)
        "phi_small_d_noexp": (lambda y, x, s, h: cuda_svgd.phi_small_d_noexp_cuda(y, x, s),
                              lambda y, x, s, h: cuda_svgd.phi_small_d_noexp_plain(y, x, s)),
    }
    # (kernel, (S, k, m, d), bandwidth, shared x, role).  The main shapes are
    # the paths': 8 lanes × 1250 rows against 10,000 particles, at banana's
    # d=3, splice's d=61 and Covertype's d=55.  Big-d checks use h = 2d so
    # the Gram stays O(1) and the check exercises exp and drive (at h=1 and
    # d=55 nearly every off-diagonal K underflows to 0); the bf16x3 tier is
    # also held at the Covertype path's own h = 1, where φ rides the Gram
    # diagonal's cancellation.  The wide-d kernels (d > 128) are held at the
    # BNN's one lane (1 × 500 × 500, d = 753) at the inputs' median-heuristic
    # h (K of order 1), with y = x at the driver's h = 1, and at h = 2d; at
    # the 8-shard BNN lanes; at a ragged d = 129; at the widest d = 2432 with
    # per-lane x; and at the north-star lane shape at d = 753.  "median" is
    # the inputs' median-heuristic h.  "self" is the Sampler's one lane at
    # h = 1: y = x = the BNN driver's initial particles, where every
    # off-diagonal K underflows and φ rides the Gram diagonal's cancellation
    # ‖y‖² + ‖y‖² − 2·y·y; that row also prints both versions' distance
    # from the float64 φ.  Every row is timed.
    cases = [
        ("phi_small_d", (8, 1250, 10_000, 3), 1.0, True, "main"),
        ("phi_small_d", (3, 1000, 777, 5), 1.0, True, "ragged"),
        ("phi_small_d", (8, 1250, 1250, 3), 1.0, False, "partitions"),
        ("phi_big_d", (8, 1250, 10_000, 61), 122.0, True, "main"),
        ("phi_big_d", (8, 1250, 10_000, 55), 110.0, True, "covertype d=55"),
        ("phi_big_d", (1, 300, 517, 9), 18.0, True, "ragged"),
        ("phi_big_d", (2, 200, 333, 128), 256.0, False, "widest"),
        ("phi_big_d_bf16x3", (8, 1250, 10_000, 55), 1.0, True, "main"),
        ("phi_big_d_bf16x3", (8, 1250, 10_000, 55), 110.0, True, "main h=2d"),
        ("phi_big_d_bf16x3", (1, 300, 517, 9), 18.0, True, "ragged"),
        ("phi_big_d_bf16x3", (3, 1000, 777, 13), 26.0, False, "ragged per-lane x"),
        ("phi_big_d_bf16x3", (2, 200, 333, 128), 256.0, False, "widest"),
        ("phi_big_d_bf16x3", (2, 200, 333, 128), 256.0, True, "widest shared x"),
        ("phi_small_d_bf16", (8, 1250, 10_000, 3), 1.0, True, "main"),
        ("phi_small_d_bf16", (3, 1000, 777, 5), 1.0, True, "ragged"),
        ("phi_small_d_bf16", (8, 1250, 1250, 3), 1.0, False, "partitions"),
        # the no-exp probe: the autotune tool's shape, the north-star lanes,
        # a ragged shape, d = 1 and d = 8
        ("phi_small_d_noexp", (1, 10_000, 10_000, 3), 1.0, True, "main"),
        ("phi_small_d_noexp", (8, 1250, 10_000, 3), 1.0, True, "north-star lanes"),
        ("phi_small_d_noexp", (3, 1000, 777, 5), 1.0, True, "ragged"),
        ("phi_small_d_noexp", (2, 300, 517, 1), 1.0, False, "d=1"),
        ("phi_small_d_noexp", (2, 300, 517, 8), 1.0, False, "d=8"),
    ]
    for name in ("phi_wide_d", "phi_wide_d_bf16x3"):
        cases += [
            (name, (1, 500, 500, 753), "median", True, "main"),
            (name, (1, 500, 500, 753), 1.0, "self", "self h=1"),
            (name, (1, 500, 500, 753), 1506.0, True, "h=2d"),
            (name, (8, 62, 496, 753), "median", True, "dist lanes"),
            (name, (1, 300, 517, 129), 258.0, True, "ragged"),
            (name, (2, 200, 333, 2432), 4864.0, False, "widest"),
            (name, (8, 1250, 10_000, 753), 1506.0, True, "throughput"),
        ]
    exact_of = {"phi_big_d_bf16x3": "phi_big_d", "phi_wide_d_bf16x3": "phi_wide_d"}
    timing = {}
    for seed, (name, (S, k, m, d), h, shared, role) in enumerate(cases):
        kern, plain = kernel_fns[name]
        y, x, s = phi_inputs(S, k, m, d, seed, shared is not False)
        if shared == "self":  # the Sampler's one lane: y is x, the BNN's init
            x = bnn.init_particles(seed, m, UCI_REGRESSION_DIMS["boston"], device="cuda")
            y = x[None].clone()
        if h == "median":
            h = float(median_bandwidth(x))
        got = kern(y, x, s, h)
        torch.cuda.synchronize()
        want = plain(y, x, s, h)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = KERNEL_RTOL * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        extra = {}
        if shared == "self":
            exact = cuda_svgd.phi_big_d_plain(y.double(), x.double(), s.double(), h)
            extra = {"max_abs_err_vs_f64": float((got.double() - exact).abs().max()),
                     "plain_max_abs_err_vs_f64": float((want.double() - exact).abs().max())}
            del exact
        del got, want
        reps = TIMED_LAUNCHES if role.startswith("main") else OTHER_LAUNCHES
        ms = cuda_ms(lambda: kern(y, x, s, h), reps)
        plain_ms = cuda_ms(lambda: plain(y, x, s, h), reps)
        b_ms, b_by = bound_ms(*phi_work(name, S, k, m, d, x.numel()))
        row = {"phase": "kernel_parity", "kernel": name, "role": role,
               "shape": [S, k, m, d], "bandwidth": h, "max_abs_err": err,
               "max_abs_plain": scale, **extra, "tolerance": tol, "ok": ok,
               "ms": ms, "plain_ms": plain_ms, "bound_us": 1e3 * b_ms, "bound_by": b_by}
        if name in BIG_D_KERNELS + WIDE_D_KERNELS:
            row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
            row["scratch_bytes"] = check_scratch(name, S, k, m, d, S if x.dim() == 3 else 1)
        if name in exact_of and role.startswith("main"):
            # the exact tier on the same inputs, beside it
            exact_kern = kernel_fns[exact_of[name]][0]
            row[f"exact_{exact_of[name]}_ms"] = cuda_ms(lambda: exact_kern(y, x, s, h), reps)
        if role == "main":
            timing[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} > {KERNEL_RTOL} × {scale}")

    # The exact big-d kernel at the paths' own h = 1 (BIG_D_SELF_CASES):
    # held against the plain version at the full shape within KERNEL_RTOL,
    # as every row above, and both printed beside the float64 φ on the first
    # LANE_ROWS rows of every lane (rows are independent).  Then the exact
    # wide-d one (WIDE_D_SELF_CASES), held against that float64 φ.
    self_cases = ([("phi_big_d", shape, role) for shape, role in BIG_D_SELF_CASES]
                  + [("phi_wide_d", shape, role) for shape, role in WIDE_D_SELF_CASES])
    for seed, (name, (S, k, m, d), role) in enumerate(self_cases, start=len(cases) + 2):
        h = 1.0
        kern = kernel_fns[name][0]
        y, x, s = phi_inputs(S, k, m, d, seed)
        got = kern(y, x, s, h)
        torch.cuda.synchronize()
        want = cuda_svgd.phi_big_d_plain(y, x, s, h)
        ys = y[:, :LANE_ROWS].contiguous()
        exact = cuda_svgd.phi_big_d_plain(ys.double(), x.double(), s.double(), h)
        vs_f64 = float((got[:, :LANE_ROWS].double() - exact).abs().max())
        vs_plain = float((got - want).abs().max())
        if name == "phi_big_d":
            err, scale, reference = vs_plain, float(want.abs().max()), "plain"
        else:
            err, scale, reference = vs_f64, float(exact.abs().max()), "phi f64"
        tol = KERNEL_RTOL * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        row = {"phase": "kernel_parity", "kernel": name, "role": role,
               "shape": [S, k, m, d], "bandwidth": h, "reference": reference,
               "max_abs_err": err, "max_abs_plain": float(want.abs().max()),
               "max_abs_ref": scale, "rows": min(k, LANE_ROWS),
               "max_abs_err_vs_f64": vs_f64,
               "plain_max_abs_err_vs_f64": float(
                   (want[:, :LANE_ROWS].double() - exact).abs().max()),
               "max_abs_err_vs_plain": vs_plain, "tolerance": tol, "ok": ok}
        del got, want, exact
        b_ms, b_by = bound_ms(*phi_work(name, S, k, m, d, x.numel()))
        row.update(ms=cuda_ms(lambda: kern(y, x, s, h),
                              TIMED_LAUNCHES if name == "phi_big_d" else OTHER_LAUNCHES),
                   plain_ms=cuda_ms(lambda: cuda_svgd.phi_big_d_plain(y, x, s, h),
                                    OTHER_LAUNCHES),
                   bound_us=1e3 * b_ms, bound_by=b_by)
        row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        row["scratch_bytes"] = check_scratch(name, S, k, m, d, 1)
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} > {KERNEL_RTOL} × {scale}")
        del y, x, s, ys

    # The small-d kernel at the W2 streaming route's φ lanes (DistSampler at
    # n = 100,000: 8 × 12,500 × 100,000, d = 3), at that path's h and at
    # h = 1.  The kernel runs at the full shape, whose k sets its m-split (2
    # chunks of 50,000 columns); its first LANE_ROWS rows of every lane are
    # held against the torch φ in float64 on those rows (rows are
    # independent; the whole Gram would be 40 GB in float32), within
    # KERNEL_RTOL · max|φ|.  The float32 plain version is no reference at
    # this m: its matmul sums 100,000 columns in long chains, and on an H100
    # it lies ~1e-4 of max|φ| from the float64 φ at h = 1; its distances
    # from both are printed.
    S, k, m, d = W2_STREAMING_PHI
    for seed, h in ((len(cases), W2_STREAMING["h"]), (len(cases) + 1, 1.0)):
        y, x, s = phi_inputs(S, k, m, d, seed)
        got = cuda_svgd.phi_small_d_cuda(y, x, s, h)[:, :LANE_ROWS]
        torch.cuda.synchronize()
        ys = y[:, :LANE_ROWS].contiguous()
        exact = phi(ys.double(), x.double(), s.double(), RBF(h))
        plain = cuda_svgd.phi_small_d_plain(ys, x, s, h)
        err = float((got.double() - exact).abs().max())
        scale = float(exact.abs().max())
        tol = KERNEL_RTOL * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        row = {"phase": "kernel_parity", "kernel": "phi_small_d",
               "role": f"w2 streaming lanes h={h:g}", "shape": [S, k, m, d], "bandwidth": h,
               "rows": LANE_ROWS, "reference": "phi f64", "max_abs_err": err,
               "max_abs_ref": scale, "tolerance": tol, "ok": ok,
               "max_abs_err_vs_plain": float((got - plain).abs().max()),
               "plain_max_abs_err_vs_f64": float((plain.double() - exact).abs().max())}
        del got, plain, exact
        b_ms, b_by = bound_ms(*phi_work("phi_small_d", S, k, m, d, x.numel()))
        row.update(ms=cuda_ms(lambda: cuda_svgd.phi_small_d_cuda(y, x, s, h),
                              MAIN_100K_LAUNCHES),
                   plain_ms_on_rows=cuda_ms(
                       lambda: cuda_svgd.phi_small_d_plain(ys, x, s, h), OTHER_LAUNCHES),
                   bound_us=1e3 * b_ms, bound_by=b_by)
        emit(row)
        if not ok:
            raise AssertionError(f"phi_small_d {row['role']}: max|Δ| {err} vs the f64 φ "
                                 f"> {tol}")
        del y, x, s, ys

    # ---- 3b. Sinkhorn kernels: parity and timing -------------------------
    ot_fns = {
        "ot_ctransform": (cuda_ot.ctransform_reduce_cuda, cuda_ot.ctransform_reduce_plain),
        "ot_kexp": (cuda_ot.kexp_cuda, cuda_ot.kexp_plain),
        "ot_kmat_vec": (cuda_ot.kmat_vec_cuda, cuda_ot.kmat_vec_plain),
        "ot_plan_grad": (cuda_ot.plan_grad_cuda, cuda_ot.plan_grad_plain),
    }
    # (kernel, (S, k, m, d), options, role); every row is timed.  The "main"
    # rows are the shapes the W2 paths give each kernel: kexp's on the 10k
    # fused route (8 lanes of 1250 rows × 10,000 particles), the 100k
    # streaming route's kmat_vec and plan_grad (8 lanes of 12,500 rows ×
    # 100,000); the c-transform's "10k main" is the fused route's, its
    # "main" the streaming route's (ot_lanes_f64_rows).  Then both
    # directions of the 10k c-transforms, one lane of the 100k shapes, and
    # ragged shapes at d = 1 and d = 8.  The main rows of kmat_vec and
    # plan_grad are held against float64 on LANE_ROWS rows a lane
    # (ot_lanes_f64_rows, same seeds and tolerance rules): at these shapes
    # the card's float32 plain plan_grad is 0.148 from the float64 value on
    # those rows, the kernel 0.0039 when the plain version was its
    # reference — the plain version was the far one.  Their rows below stay
    # in the list so that every other row keeps its seed.
    ot_cases = [
        ("ot_ctransform", (8, 1250, 10_000, 3), {"soft": True}, "10k main"),
        ("ot_ctransform", (8, 1250, 10_000, 3), {"soft": False}, "10k hard"),
        ("ot_ctransform", (8, 10_000, 1250, 3), {"soft": True}, "10k transposed soft"),
        ("ot_ctransform", (8, 10_000, 1250, 3), {"soft": False}, "10k transposed hard"),
        ("ot_kexp", (8, 1250, 10_000, 3), {}, "main"),
        ("ot_kmat_vec", (8, 12_500, 100_000, 3), {"r": 1}, "main"),
        ("ot_plan_grad", (8, 12_500, 100_000, 3), {}, "main"),
        ("ot_kmat_vec", (1, 12_500, 100_000, 3), {"r": 1}, "100k lane"),
        ("ot_kmat_vec", (1, 100_000, 12_500, 3), {"r": 1}, "100k lane transposed"),
        ("ot_kmat_vec", (1, 12_500, 100_000, 3), {"r": 3}, "100k lane r=3"),
        ("ot_plan_grad", (1, 12_500, 100_000, 3), {}, "100k lane"),
        ("ot_ctransform", (1, 12_500, 100_000, 3), {"soft": True}, "100k lane soft"),
    ]
    ragged_opts = {"ot_ctransform": [{"soft": True}, {"soft": False}],
                   "ot_kmat_vec": [{"r": 1}, {"r": 5}]}
    for name in ot_fns:
        for shape in ((3, 1001, 777, 1), (2, 333, 517, 8)):
            for opt in ragged_opts.get(name, [{}]):
                ot_cases.append((name, shape, opt, "ragged"))
    f64_rows = {(name, role) for name, _, role, _ in W2_STREAMING_OT}
    for seed, (name, (S, k, m, d), opt, role) in enumerate(ot_cases):
        if (name, role) in f64_rows:
            continue  # against float64 in ot_lanes_f64_rows
        kern, plain = ot_fns[name]
        big = max(k, m) >= 100_000
        reps = (OTHER_LAUNCHES if role not in ("main", "10k main")
                else MAIN_100K_LAUNCHES if big else TIMED_LAUNCHES)
        rows, cols, f, gpot, p, rhs = ot_inputs(S, k, m, d, 100 + seed)
        if name == "ot_ctransform":
            args = (rows, cols, p, opt["soft"])
        elif name == "ot_kmat_vec":
            r = opt["r"]
            args = (rows, cols, f, gpot, rhs[..., 0].contiguous() if r == 1
                    else rhs[..., :r].contiguous())
        else:
            args = (rows, cols, f, gpot)
        got = kern(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        terms = plan_grad_terms(rows, cols, f, gpot) if name == "ot_plan_grad" else 0.0
        ok, err, tol, scale = ot_check(name, got, want, soft=opt.get("soft", False),
                                       terms=terms)
        row = {"phase": "kernel_parity", "kernel": name, "role": role,
               "shape": [S, k, m, d], **opt, "max_abs_err": err,
               "max_abs_plain": scale, "tolerance": tol, "ok": ok}
        del got, want
        ms = cuda_ms(lambda: kern(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), min(reps, PLAIN_100K_REPS) if big else reps)
        b_ms, b_by = bound_ms(*ot_work(name, S, k, m, d, **opt))
        row.update(ms=ms, plain_ms=plain_ms, bound_us=1e3 * b_ms, bound_by=b_by)
        if name in STREAMING_OT and opt.get("soft", True):
            row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        if role == "main":
            timing[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} over tolerance {tol}")
    big_d_profile_rows()
    wide_d_profile_rows()
    ot_lanes_f64_rows(timing)
    ct_rescale_rows()
    gs_probe_rows()

    # ---- 4. north star ---------------------------------------------------
    ns = NORTH_STAR
    fold = load_benchmark("banana", 42)
    data = (torch.as_tensor(fold.x_train), torch.as_tensor(fold.t_train.reshape(-1)))
    x_test = torch.as_tensor(fold.x_test).cuda()
    t_test = torch.as_tensor(fold.t_test.reshape(-1)).cuda()
    d = 1 + fold.x_train.shape[1]
    init = init_particles_per_shard(0, ns["n"], d, ns["shards"])

    def sampler(particles, data, phi_impl="auto"):
        return DistSampler(ns["shards"], logreg_logp, None, particles, data=data,
                           exchange_particles=True, exchange_scores=False,
                           include_wasserstein=False, phi_impl=phi_impl)

    ds = sampler(init, data)
    ds.run_steps(ns["warm_steps"], ns["step_size"])
    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    ds.run_steps(ns["steps"], ns["step_size"])
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches_small = dict(cuda_svgd.launch_counts)
    dev_ms = start.elapsed_time(end)
    clocks = smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    finite = bool(torch.isfinite(ds.particles).all())
    acc = float(ensemble_test_accuracy(ds.particles, x_test, t_test))
    emit({"phase": "north_star", "dataset": "banana", "fold": 42, "n": ns["n"],
          "shards": ns["shards"], "d": d, "steps": ns["steps"],
          "updates_per_s": ns["n"] * ns["steps"] / host_s,
          "ms_per_step": 1e3 * host_s / ns["steps"],
          "event_ms_per_step": dev_ms / ns["steps"],
          "launches": launches_small, "finite": finite, "test_accuracy": acc,
          "clocks_sm,power_draw,power_limit,temp": clocks})
    if not finite or launches_small != phi_counts(phi_small_d=ns["steps"]):
        raise AssertionError(f"north star: finite={finite} launches={launches_small}")

    # ---- 4b. where a north-star step's time goes (torch.profiler) ---------
    emit(profile_steps(lambda: ds.run_steps(PROFILE_STEPS, ns["step_size"]), PROFILE_STEPS))

    # ---- 5. trajectory: hand kernel vs plain φ on the card ----------------
    runs = {}
    for impl in ("cuda", "torch"):
        dt = sampler(init, data, phi_impl=impl)
        dt.run_steps(TRAJECTORY_STEPS, ns["step_size"])
        runs[impl] = dt.particles
    dev = float((runs["cuda"] - runs["torch"]).abs().max())
    rel = dev / float(runs["torch"].abs().max())
    emit({"phase": "trajectory", "steps": TRAJECTORY_STEPS, "max_abs_dev": dev,
          "rel_dev": rel, "bound": TRAJ_RTOL, "ok": rel <= TRAJ_RTOL})
    if not rel <= TRAJ_RTOL:
        raise AssertionError(f"trajectory: {rel} > {TRAJ_RTOL}")

    # ---- 6. big-d path: splice (d = 61) ----------------------------------
    sfold = load_benchmark("splice", 1)
    sdata = (torch.as_tensor(sfold.x_train), torch.as_tensor(sfold.t_train.reshape(-1)))
    sd = 1 + sfold.x_train.shape[1]
    sds = sampler(init_particles_per_shard(0, ns["n"], sd, ns["shards"]), sdata)
    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    t0 = time.perf_counter()
    sds.run_steps(BIG_D_STEPS, ns["step_size"])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches_big = dict(cuda_svgd.launch_counts)
    finite = bool(torch.isfinite(sds.particles).all())
    sacc = float(ensemble_test_accuracy(
        sds.particles, torch.as_tensor(sfold.x_test).cuda(),
        torch.as_tensor(sfold.t_test.reshape(-1)).cuda()))
    emit({"phase": "big_d", "dataset": "splice", "fold": 1, "n": ns["n"], "d": sd,
          "steps": BIG_D_STEPS, "ms_per_step": 1e3 * host_s / BIG_D_STEPS,
          "updates_per_s": ns["n"] * BIG_D_STEPS / host_s,
          "launches": launches_big, "finite": finite, "test_accuracy": sacc})
    if not finite or launches_big != phi_counts(phi_big_d=BIG_D_STEPS):
        raise AssertionError(f"big-d path: finite={finite} launches={launches_big}")

    # ---- 6b. the small-d bf16 tier: a short banana run ---------------------
    bds = sampler(init, data, phi_impl="cuda_bf16")
    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    t0 = time.perf_counter()
    bds.run_steps(BANANA_BF16_STEPS, ns["step_size"])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches_sbf = dict(cuda_svgd.launch_counts)
    finite = bool(torch.isfinite(bds.particles).all())
    emit({"phase": "banana_bf16", "dataset": "banana", "fold": 42, "n": ns["n"], "d": d,
          "phi_impl": "cuda_bf16", "steps": BANANA_BF16_STEPS,
          "ms_per_step": 1e3 * host_s / BANANA_BF16_STEPS, "launches": launches_sbf,
          "finite": finite,
          "test_accuracy": float(ensemble_test_accuracy(bds.particles, x_test, t_test))})
    if not finite or launches_sbf != phi_counts(phi_small_d_bf16=BANANA_BF16_STEPS):
        raise AssertionError(f"banana bf16: finite={finite} launches={launches_sbf}")
    del bds

    # ---- 7. W2 north star: Sinkhorn at 10k, the fused route --------------
    def w2_sampler(particles, **kw):
        return DistSampler(ns["shards"], logreg_logp, None, particles, data=data,
                           exchange_particles=True, exchange_scores=False,
                           include_wasserstein=True, wasserstein_solver="sinkhorn", **kw)

    def reset_counts():
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        cuda_ot.reset_launch_counts()

    def counts():
        return {**cuda_svgd.launch_counts, **cuda_ot.launch_counts}

    w2 = W2_NORTH_STAR
    wds = w2_sampler(init)
    wds.run_steps(w2["warm_steps"], ns["step_size"], h=w2["h"])
    reset_counts()
    t0 = time.perf_counter()
    wds.run_steps(w2["steps"], ns["step_size"], h=w2["h"])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches_w2 = counts()
    finite = bool(torch.isfinite(wds.particles).all())
    acc = float(ensemble_test_accuracy(wds.particles, x_test, t_test))
    emit({"phase": "w2_north_star", "dataset": "banana", "fold": 42, "n": w2["n"],
          "shards": ns["shards"], "d": d, "steps": w2["steps"], "h": w2["h"],
          "route": "fused", "ms_per_step": 1e3 * host_s / w2["steps"],
          "updates_per_s": w2["n"] * w2["steps"] / host_s, "launches": launches_w2,
          "scaling_blocks_per_step": launches_w2["ot_kexp"] / w2["steps"],
          "finite": finite, "test_accuracy": acc,
          "clocks_sm,power_draw,power_limit,temp": smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    if not (finite and launches_w2["ot_ctransform"] >= 2 * w2["steps"]
            and launches_w2["ot_kexp"] >= w2["steps"]
            and launches_w2["ot_kmat_vec"] == launches_w2["ot_plan_grad"] == 0
            and launches_w2["phi_small_d"] == w2["steps"]):
        raise AssertionError(f"w2 north star: finite={finite} launches={launches_w2}")

    # ---- 7b. where a W2 step's time goes (torch.profiler) -----------------
    emit(profile_steps(lambda: wds.run_steps(W2_PROFILE_STEPS, ns["step_size"], h=w2["h"]),
                       W2_PROFILE_STEPS, phase="w2_profile"))

    # ---- 7c. what one host sync of the tol exit costs ---------------------
    # sinkhorn_tol=None, iters=10: one scaling block a solve and no sync;
    # tol=1e9, iters=20: the cold-start first block runs every lane without
    # a sync, then one sync finds every lane within tol and the solve stops —
    # the same work and one sync more.  Run in turns: A, B, B, A, twice.
    sync_ms = {"no_sync": [], "one_sync": []}
    blocks = {}
    for label in ("no_sync", "one_sync", "one_sync", "no_sync") * 2:
        kw = (dict(sinkhorn_tol=None, sinkhorn_iters=10) if label == "no_sync"
              else dict(sinkhorn_tol=1e9, sinkhorn_iters=20))
        yds = w2_sampler(init, **kw)
        yds.run_steps(3, ns["step_size"], h=w2["h"])
        reset_counts()
        t0 = time.perf_counter()
        yds.run_steps(W2_SYNC_STEPS, ns["step_size"], h=w2["h"])
        torch.cuda.synchronize()
        sync_ms[label].append(1e3 * (time.perf_counter() - t0) / W2_SYNC_STEPS)
        blocks[label] = cuda_ot.launch_counts["ot_kexp"] / W2_SYNC_STEPS
    emit({"phase": "w2_sync_cost", "steps": W2_SYNC_STEPS, "ms_per_step": sync_ms,
          "kexp_per_step": blocks,
          "ms_per_sync": (sum(sync_ms["one_sync"]) - sum(sync_ms["no_sync"])) / 4})
    if blocks != {"no_sync": 1.0, "one_sync": 1.0}:
        raise AssertionError(f"w2 sync cost: scaling blocks per step {blocks}")

    # ---- 8. W2 at 100k: the streaming route --------------------------------
    st = W2_STREAMING
    sds = w2_sampler(init_particles_per_shard(0, st["n"], d, ns["shards"]))
    sds.run_steps(st["warm_steps"], ns["step_size"], h=st["h"])  # no W2 yet
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sds.run_steps(st["steps"], ns["step_size"], h=st["h"])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches_st = counts()
    finite = bool(torch.isfinite(sds.particles).all())
    emit({"phase": "w2_streaming", "dataset": "banana", "n": st["n"],
          "shards": ns["shards"], "d": d, "steps": st["steps"], "h": st["h"],
          "route": "streaming", "ms_per_step": 1e3 * host_s / st["steps"],
          "updates_per_s": st["n"] * st["steps"] / host_s, "launches": launches_st,
          "scaling_iterations_per_step": launches_st["ot_kmat_vec"] / 2 / st["steps"],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "finite": finite,
          "test_accuracy": float(ensemble_test_accuracy(sds.particles, x_test, t_test))})
    if not (finite and launches_st["ot_kmat_vec"] > 0 and launches_st["ot_plan_grad"] > 0
            and launches_st["ot_ctransform"] >= 2 * st["steps"]
            and launches_st["ot_kexp"] == 0):
        raise AssertionError(f"w2 streaming: finite={finite} launches={launches_st}")

    # ---- 8b. where a W2 streaming step's time goes (torch.profiler) --------
    emit(profile_steps(
        lambda: sds.run_steps(W2_STREAMING_PROFILE_STEPS, ns["step_size"], h=st["h"]),
        W2_STREAMING_PROFILE_STEPS, phase="w2_streaming_profile", top=12))
    del sds

    # ---- 9. W2 trajectory: kernel route vs torch route on the card --------
    tr = W2_TRAJECTORY
    runs = {}
    for impl in ("cuda", "torch"):
        tds = w2_sampler(init, sinkhorn_tol=None, sinkhorn_iters=tr["iters"])
        tds._sinkhorn_impl = impl  # the route the W2 step is built with
        tds.run_steps(tr["steps"], ns["step_size"], h=w2["h"])
        runs[impl] = tds.particles
    dev = float((runs["cuda"] - runs["torch"]).abs().max())
    rel = dev / float(runs["torch"].abs().max())
    emit({"phase": "w2_trajectory", "steps": tr["steps"], "sinkhorn_iters": tr["iters"],
          "max_abs_dev": dev, "rel_dev": rel, "bound": TRAJ_RTOL, "ok": rel <= TRAJ_RTOL})
    if not rel <= TRAJ_RTOL:
        raise AssertionError(f"w2 trajectory: {rel} > {TRAJ_RTOL}")

    # ---- 10. small-input reference: card f32 vs CPU f64 --------------------
    import numpy as np

    rng = np.random.default_rng(7)
    worst = 0.0
    for dd in (3, 12):
        parts = rng.normal(size=(64, dd))
        xr = rng.normal(size=(48, dd - 1))
        tr = np.where(rng.normal(size=48) > 0, 1.0, -1.0)
        for exch_p, exch_s in ((True, False), (True, True), (False, False)):
            out = {}
            for dev_name, impl, dtype in (("cuda", "cuda", np.float32),
                                          ("cpu", "torch", np.float64)):
                r = DistSampler(4, logreg_logp, None, parts.astype(dtype),
                                data=(xr, tr), exchange_particles=exch_p,
                                exchange_scores=exch_s, include_wasserstein=False,
                                phi_impl=impl, device=dev_name)
                r.run_steps(3, 0.05)
                out[dev_name] = r.particles.double().cpu()
            rel = float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max())
            worst = max(worst, rel)
    emit({"phase": "small_reference", "modes": 3, "dims": [3, 12],
          "max_rel_dev": worst, "bound": SMALL_RTOL, "ok": worst <= SMALL_RTOL})
    if not worst <= SMALL_RTOL:
        raise AssertionError(f"small reference: {worst} > {SMALL_RTOL}")

    # the same with the W2 term: every mode and pairing, the card's kernel
    # route (float32) against the CPU's torch route (float64)
    parts = rng.normal(size=(64, 3))
    xr = rng.normal(size=(48, 2))
    tr_ = np.where(rng.normal(size=48) > 0, 1.0, -1.0)
    worst = 0.0
    cases = 0
    for exch_p, exch_s in ((True, False), (True, True), (False, False)):
        for pairing in (("global", "block") if exch_p else ("block",)):
            out = {}
            for dev_name, impl, dtype in (("cuda", "cuda", np.float32),
                                          ("cpu", "torch", np.float64)):
                r = DistSampler(4, logreg_logp, None, parts.astype(dtype),
                                data=(xr, tr_), exchange_particles=exch_p,
                                exchange_scores=exch_s, include_wasserstein=True,
                                wasserstein_solver="sinkhorn", sinkhorn_tol=None,
                                w2_pairing=pairing, phi_impl=impl, device=dev_name)
                r.run_steps(4, 0.05, h=1.0)
                out[dev_name] = r.particles.double().cpu()
            worst = max(worst, float((out["cuda"] - out["cpu"]).abs().max()
                                     / out["cpu"].abs().max()))
            cases += 1
    emit({"phase": "small_reference_w2", "cases": cases, "d": 3, "steps": 4,
          "max_rel_dev": worst, "bound": W2_SMALL_RTOL, "ok": worst <= W2_SMALL_RTOL})
    if not worst <= W2_SMALL_RTOL:
        raise AssertionError(f"small W2 reference: {worst} > {W2_SMALL_RTOL}")

    # ---- 11. Covertype (BASELINE config 4) through its driver --------------
    launches_ct = covertype_phases()
    covertype_nproc1_phase()

    # ---- 12. the BNN (BASELINE config 5, d = 753) through its driver -------
    launches_bnn, launches_bnn_bf16 = bnn_phases()

    # ---- 13. the autotune tool and the φ policy's gates ---------------------
    launches_tool = autotune_phase()
    auto_gates_phase()

    # ---- 14. the reference's entry points (BASELINE configs 1-2) -----------
    logreg_phases()
    gmm_phase()

    # each kernel's launches on the path whose shape its timed row has (the
    # c-transform's is the streaming route's; the W2 north star launches it
    # 200 times too, checked above)
    launches = {"phi_small_d": launches_small["phi_small_d"],
                "phi_big_d": launches_big["phi_big_d"],
                "ot_ctransform": launches_st["ot_ctransform"],
                "ot_kexp": launches_w2["ot_kexp"],
                "ot_kmat_vec": launches_st["ot_kmat_vec"],
                "ot_plan_grad": launches_st["ot_plan_grad"],
                "phi_small_d_bf16": launches_sbf["phi_small_d_bf16"],
                "phi_big_d_bf16x3": launches_ct["phi_big_d_bf16x3"],
                "phi_wide_d": launches_bnn["phi_wide_d"],
                "phi_wide_d_bf16x3": launches_bnn_bf16["phi_wide_d_bf16x3"],
                "phi_small_d_noexp": launches_tool["phi_small_d_noexp"]}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": launches[name],
         "max_abs_err": timing[name]["max_abs_err"], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"], "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": None}
        for name, meta in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
