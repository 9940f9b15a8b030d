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
and the float64 φ in ``kernel_parity``) and ``gmm.py``, then the
resumable, budgeted runs: the ring exchange at the north star against the
gather, ``dist_svgd_torch/tools/large_n.py`` at 100,000 particles (the
ring with the block pairing and the gather with the global one, each
monolithic and under a dispatch budget that splits every Sinkhorn solve
in two), the 10,000-particle solve split, a 100,000-particle W2 run
checkpointed, resumed bitwise and resumed at 4 shards, the lagged
Covertype (both tiers) and BNN drivers, the Covertype cadences and a
resume, and the 100,000-particle ring step's pairs a second (the
chunked planner's rate), with their kernels held at the new per-lane
shapes in ``kernel_parity``; then the observability layer — the north star
under the span tracer with a dispatch budget (traced against untraced),
the posterior diagnostics on its final particles (float32 against float64)
and on the Covertype and BNN ensembles — and the sub-quadratic φ: the
``large_n_approx`` rows of ``tools/large_n.py`` at 100,000 particles, the
``'auto'`` crossover's ladder of the exact φ against random features and
Nyström, and the north star with ``kernel_approx`` — and last the supervised
runs: ``dist_svgd_torch/experiments/resilient_covertype.py`` at config 4's
widths killed and resumed bitwise (an injected preemption in process, a
real SIGTERM to a subprocess), the guards' NaN rollback, a retry and an
exhausted restart budget with their postmortem bundles read back by
``dist_svgd_torch/tools/trace_report.py``, the north star resharded
8 → 4 → 8 → 5 shards against the never-resharded run, and
``dist_svgd_torch/tools/fault_drill.py`` at its defaults, with
``phi_small_d`` held at the resharded and drill lanes in
``kernel_parity`` — and then the serving layer: ``dist_svgd_torch/
experiments/serve_covertype.py`` at its defaults (train, cold start,
a concurrent HTTP self-test), ``dist_svgd_torch/tools/serve_bench.py`` at
its defaults and with an open loop, four lanes, bf16 and three tenants
(no graph capture or kernel build in any timed window), every bucket's
CUDA graph against the eager function underneath it, the dispatch
profiler's A/B cost and a hot reload under concurrent predicts, with both
big-d φ tiers held at the serving paths' training lanes; it checks that
each path went through its kernels, and prints one JSON object per phase.  A
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

# Resumable, budgeted runs (the ring and lagged exchanges, chunked
# run_steps, checkpoints and step metrics):
# - the φ kernels at the shapes these paths give them, per-lane visiting
#   blocks / views (kernel, (S, k, m, d), h, y taken from x's first rows,
#   role): the 100k ring hop (12,500 rows against each lane's visiting
#   block), the lagged Covertype view (the own block is the view's first
#   rows, h = 1) in both tiers, the lagged BNN view at --nproc 8;
#   the d ≤ 8 and the exact big-d rows held against the float64 φ on
#   LANE_ROWS rows a lane, the bf16x3 row against its plain version;
# - the Sinkhorn kernels at the 100k ring's block-pairing solve, (8,
#   12,500, 12,500, 3), its dual-advance start passes and scalings;
# - the north star under the ring (both all_* modes, ring against gather
#   over RING_STEPS, within TRAJ_RTOL · max|θ|);
# - the port's tools/large_n.py at n = 100,000, 8 shards: the ring with
#   the block pairing (fused route at 12,500² pairs a lane), monolithic and
#   under a dispatch budget that plans intra_step with two W2 dispatches a
#   step (LARGE_N budget / pairs_per_sec), and the gather with the global
#   pairing (the streaming route) under the same budget; and a ring
#   parity run of both executions at sinkhorn_tol=None;
# - the 10k fused route with its solve split (max_passes_per_dispatch);
# - a 100k W2 streaming run saved at step 2 and resumed (bitwise at step
#   4), then resumed at 4 shards;
# - Covertype lagged (--exchange-every 4) in both tiers, its cadences
#   (--checkpoint-every 50 --log-every 10 --profile-dir) and a resume; the
#   BNN lagged at --nproc 8 --exchange-every 5; the pairs/s of the 100k
#   ring step behind distsampler.DISPATCH_PAIRS_PER_SEC.
LANE_CASES = [("phi_small_d", (8, 12_500, 12_500, 3), 1.0, False, "ring hop 100k"),
              ("phi_small_d", (8, 1250, 1250, 3), 1.0, False, "ring hop north star"),
              ("phi_big_d", (8, 1250, 10_000, 55), 1.0, True, "lagged covertype view h=1"),
              ("phi_big_d_bf16x3", (8, 1250, 10_000, 55), 1.0, True,
               "lagged covertype view h=1"),
              ("phi_wide_d", (8, 62, 496, 753), 1.0, True, "lagged bnn view h=1")]
LANE_SEED = 600
RING_OT = [("ot_ctransform", (8, 12_500, 12_500, 3), "100k ring block pairing start", 601),
           ("ot_kexp", (8, 12_500, 12_500, 3), "100k ring block pairing", 602)]
RING_STEPS = 20
LARGE_N = dict(n=100_000, shards=8, steps=2, samples=1, pairs_per_sec=1e11,
               budget={"ring": 1.3, "gather": 10.3}, parity_steps=4, parity_iters=200)
W2_CHUNKED = dict(steps=10, max_passes=100)
CHECKPOINT = dict(steps=4, save_at=2, reshard_to=4)
CT_LAGGED = dict(exchange_every=4, niter=200)
CT_CADENCES = dict(niter=100, checkpoint_every=50, log_every=10)
BNN_LAGGED = dict(nproc=8, exchange_every=5, niter=50)
PAIRS_RATE = dict(n=100_000, shards=8, warm_steps=2, steps=5)
# Observability and the sub-quadratic φ:
# - telemetry_north_star: the north star (10,000 particles, 8 shards) under
#   telemetry.enable() with a dispatch budget of TELEMETRY["chunk"] steps
#   at DISPATCH_PAIRS_PER_SEC (two train.step_chunk dispatches a run),
#   traced against untraced in turns, the Chrome export parsed;
# - diagnostics: PosteriorDiagnostics on the north star's final particles
#   at max_points = 10,000 with the full-data scores and 8 shards, float32
#   against float64 on the card (KSD and ESS within DIAG["rtol"]); then the
#   Covertype ensemble after DIAG["ct_steps"] exact-tier steps (d = 55) and
#   the BNN driver's after DIAG["bnn_niter"] (d = 753) at the defaults,
#   with ensemble_health / ReloadPolicy;
# - large_n_approx: tools/large_n.py --kernel-approx at n = 100,000,
#   R = L = 4096, with the exact probe at 65,536 particles on phi_small_d;
# - approx_crossover: the exact φ ('auto': phi_small_d), phi_rff and
#   phi_nystrom at k = m = n, d = 3, R = L in CROSSOVER["dials"], n
#   doubling, CROSSOVER["reps"] CUDA-event-timed calls each.  A method is
#   faster at a rung only where it beats the exact φ by more than
#   CROSSOVER["margin"] (a win inside the spread of repeated runs is not a
#   measured one).  'auto' switches at n = 2·factor·F; that point must lie
#   at or above the first rung of the method's run of faster rungs up to
#   the top, or above the ladder where the top rung is not faster, so no
#   unmeasured gap below a win is taken approximate.  A committed
#   APPROX_CROSSOVER_FACTOR that breaks this fails the phase;
# - approx_north_star: the north star with kernel_approx under 'auto' and
#   'torch', its residual gauges, and 20 steps of the card's float32 RFF
#   run against the CPU's float64 one on the same bank (APPROX_NS).
TELEMETRY = dict(steps=100, chunk=50)
DIAG = dict(max_points=10_000, shards=8, rtol=1e-4, ct_steps=20, bnn_niter=100, computes=3)
APPROX_LARGE_N = dict(n=100_000, dial=4096, steps=5, samples=2, pin_n=2048,
                      exact_probe_n=65_536)
CROSSOVER = dict(ns=(8192, 16_384, 32_768, 65_536, 131_072, 262_144), dials=(2048, 4096),
                 d=3, reps=10, margin=0.05)
APPROX_NS = dict(steps=50, num_features=2048, num_landmarks=2048, traj_steps=20,
                 traj_rtol=1e-4, residual_points=512)
# The keys of a line of the JAX Covertype driver's metrics log.
JSONL_KEYS = {"ts", "step", "wall_s", "updates_per_sec", "particle_mean_norm",
              "particle_norm_std", "particle_mean", "mean_update", "max_update"}

# Supervised, fault-tolerant runs (resilience/):
# - supervised_covertype: the port's experiments/resilient_covertype.py in
#   process at config 4's widths (SUPERVISED_CT): a supervised reference
#   run, the same run preempted at kill_step by an injected PreemptAt, and
#   its resume, bitwise the reference; phi_big_d once a step (60 + 30 + 30);
# - supervised_covertype_sigterm: the same driver as a subprocess with
#   --real-signals, sent one SIGTERM once its kill run's step_<wait_step>
#   checkpoint exists (SIGTERM_RUN; niter raised so the signal lands well
#   before the run ends), every wait bounded;
# - supervised_guards: the config-4 sampler under RunSupervisor (GUARDS)
#   with diagnostics and GuardConfig(min_ess_frac): a clean reference, an
#   InjectNaNAt (rollback, step size halved), a RaiseAt (one retry with an
#   injected sleep, bitwise the reference), a budget of 0 (exhausted), and
#   the flight recorder's bundles read back by tools/trace_report.py;
# - elastic_reshard: the north star (banana, 10,000 particles, 8 shards;
#   every shard scores against the whole training set, whose rows would
#   otherwise split S ways) under ReshardPolicy (ELASTIC): shrink 8 → 4,
#   grow 4 → 8, a device loss at 8 leaving 7 (→ 5, the largest divisor of
#   10,000 not above 7), against the never-resharded run;
# - fault_drill: the port's tools/fault_drill.py at its defaults (GMM,
#   n = 2048, 4 shards, 48 steps, checkpoints every 16);
# - the phi_small_d lanes these paths give the kernel (RESHARD_LANES: the
#   resharded north star at 4 and 5 shards, the drill's GMM lanes), held in
#   kernel_parity against the plain version and the float64 φ; seeds after
#   every older row's.
SUPERVISED_CT = dict(nrows=50_000, nproc=8, nparticles=10_000, batch_size=256, niter=60,
                     checkpoint_every=20, segment_steps=10, kill_step=30)
# Saves of the warmed config-4 state timed part by part.
CKPT_PARTS_REPS = 5
SIGTERM_RUN = dict(niter=120, wait_step=20, timeout_s=600)
GUARDS = dict(steps=40, checkpoint_every=20, segment_steps=10, fault_step=10,
              diag_every=20, min_ess_frac=0.5, backoff_base_s=0.25)
ELASTIC = dict(steps=60, checkpoint_every=10, segment_steps=5, shrink=(15, 4), grow=(35, 8),
               loss=(55, 1))
RESHARD_LANES = [((4, 2500, 10_000, 3), "elastic north star 4 shards"),
                 ((5, 2000, 10_000, 3), "elastic north star 5 shards"),
                 ((4, 512, 2048, 2), "fault drill lanes")]
RESHARD_SEED = 700

# Posterior-predictive serving (serving/, parallel/plan.py, the dispatch
# profiler and the usage meter):
# - serve_covertype: the port's experiments/serve_covertype.py at its
#   defaults (20,000 rows, 8 shards, 1,024 particles, 100 steps of 1e-4,
#   B = 256; on the card 'auto' is the bf16 tier), its concurrent HTTP
#   self-test (served against a direct call, bitwise flag beside it), and the
#   served ensemble's card float32 predictions on the test rows against a CPU
#   float64 engine's on the same ensemble (CARD_VS_F64_TOL);
# - serve_bench: dist_svgd_torch/tools/serve_bench.py at its defaults
#   (logreg, 10,000 particles, 54 features, max_batch 256, 16 closed-loop
#   clients, 2,000 requests of 1, 4 or 16 rows), then an open loop at half
#   the closed loop's rps, --lanes 4, --dtype bfloat16 and --tenants 3:
#   recompiles and sentry_compiles 0, the eviction and quota probes firing;
# - serve_buckets: every bucket program of that 10,000 × 55 engine, f32 and
#   bf16, its CUDA graph against the eager function underneath it (host p50
#   of a whole call — copy in, run, fetch — and CUDA-event ms of the device
#   work alone), the bf16 graphs against the f32 ones and the CPU's bf16
#   engine, and served against direct at request sizes 1..256 (SERVED_TOL);
# - profiler_overhead: serve_bench's closed loop with the dispatch profiler
#   and the usage meter off and on, interleaved, best of SERVING["ab_rounds"],
#   each round's rps and their spread printed; the instruments' added time a
#   batch on the dispatch path, times the closed loop's batch rate, held to
#   JAX's 3% gate;
# - serve_hot_reload: lanes and direct callers predicting on the 10,000 × 55
#   engine while a CheckpointHotReloader swaps in a newer step;
# - the φ lanes these paths give the kernels (SERVING_LANES: the
#   serve_covertype training's bf16x3 lanes, the resilient driver's exact
#   lanes at its defaults) in kernel_parity, seeds from SERVING_SEED (after
#   every older row's); the exact one also against the float64 φ.
SERVING = dict(n=10_000, features=54, ab_rounds=8, ab_requests=2000, bucket_reps=100,
               reload_threads=4, reload_calls=40, served_sizes=(1, 2, 3, 5, 8, 13, 16, 31,
                                                                33, 64, 100, 128, 200, 256))
SERVING_LANES = [("phi_big_d_bf16x3", (8, 128, 1024, 55), "serve_covertype training lanes h=1"),
                 ("phi_big_d", (4, 128, 512, 55), "resilient driver lanes h=1")]
SERVING_SEED = 800
# Served against direct class probabilities, and the card's float32
# predictions against the CPU's float64 ones on the same ensemble.
SERVED_TOL = 1e-6
CARD_VS_F64_TOL = 1e-5
# The bf16 engine's programs (serve_buckets): each graph against its eager
# function within one bf16 unit in the last place (2**-7 of the output's
# largest magnitude), and against the CPU's bf16 engine within two (the
# product and the reduction may each round in another order); against the
# f32 engine at JAX's bf16 tolerances (tests/test_plan.py): rtol 5e-2 and
# atol 2e-2 on the mean, rtol 2e-1 and atol 2e-2 on the variance.
BF16_ULP = 2.0 ** -7
BF16_VS_F32 = {"mean": (5e-2, 2e-2), "var": (2e-1, 2e-2)}

# Section 20 (progressive delivery and telemetry history, after serving):
# - rollout_drill: dist_svgd_torch/tools/rollout_drill.py at the serving
#   width (logreg, SERVING["n"] particles × 55, one pinned bucket of
#   ROLLOUT_DRILL["rows"] rows) and the drill's default durations, every
#   row_ok gate held (the shadow-overhead one on the mirror's timed share of
#   the client path; JAX's median pair p99 ratio printed beside it, with each
#   pair's ratio and their spread);
# - rollout_offer: serve_covertype's training (ROLLOUT_TRAIN: 20,000 rows,
#   8 shards, 1,024 particles, B = 256, the bf16x3 φ at (8, 128, 1024, 55))
#   on the card, 100 steps, then 100 more resumed into the same
#   CheckpointManager root; a CheckpointHotReloader(rollout=...) offers the
#   newer step and a replayed trace (ROLLOUT_TRAFFIC) feeds the candidate's
#   windows until it promotes through every stage of ROLLOUT_PLAN (the
#   drill's fast plan, with its own divergence line).  The training's
#   phi_big_d_bf16x3 launches are counted, and one call at its lanes is held
#   against the plain version within KERNEL_RTOL; the promoted generation serves the newer step's
#   particles (SERVED_TOL).  Then the newer step, saturated
#   (BadGenerationAt), is offered and must roll back with no checkpoint read
#   and the incumbent's bucket graph bitwise unchanged.  The plan's
#   divergence line is this posterior's: after 200 steps at 1e-4 the
#   ensemble is still diffuse (served means near 0.5), so a saturated step
#   lands near, not far past, JAX's 0.05.  0.015 lies between the two
#   candidates, and the phase holds both sides of it in each run: every
#   8-row request of the held-out pool diverges from step 100 by at most
#   line / DIVERGENCE_MARGIN under step 200 and by at least
#   DIVERGENCE_MARGIN × line under the saturated step (the row prints the
#   quantiles of both);
# - cost_drill: dist_svgd_torch/tools/cost_drill.py at its defaults, every
#   row_ok gate held (attribution coverage, tenant sum, zero captures, the
#   instruments' share of the dispatch thread); its history ring read back
#   by trace_report --programs (exit 0, per-program dispatches, rows and
#   bytes equal to the final dump's, seconds within HISTORY_SUM_RTOL) and by
#   the anomaly report.  On the card the defaults are the drill's
#   CARD_TENANTS, JAX's tenants at 256× the particles, so that a dispatch is
#   compute-dominant as JAX sized it to be (cost_drill's docstring).
ROLLOUT_DRILL = dict(rows=8, overhead_pairs=4)
ROLLOUT_TRAIN = dict(nrows=20_000, nproc=8, nparticles=1024, stepsize=1e-4, batch_size=256,
                     seed=0, niter=100)
ROLLOUT_PLAN = dict(shadow_fraction=0.25, shadow_min_mirrors=8, shadow_hold_s=0.5,
                    canary_stages=(0.02, 0.10, 0.50, 1.0), stage_hold_s=0.4,
                    stage_min_requests=4, max_divergence=0.015, p99_ms=150.0,
                    breach_streak=2, seed=3)
DIVERGENCE_MARGIN = 1.5
ROLLOUT_TRAFFIC = dict(rows=8, base_rps=200.0, duration_s=6.0, control_interval_s=0.15,
                       timeout_s=60.0)
ROLLOUT_SEED = 900
# The ring's windows telescope to the final dump: the summed seconds differ
# from the dump's by float64 rounding of a few dozen subtractions.
HISTORY_SUM_RTOL = 1e-9

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
    bf16 tier's launch counts of its first timed turn and each tier's
    ms/step by turn."""
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
    return launches_ct, {t: [r["ms_per_step"] for r in rows] for t, rows in ct_rows.items()}


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


def lane_rows():
    """The φ kernels at the ring's and the lagged exchange's per-lane
    shapes (LANE_CASES): each
    lane's own rows against its own visiting block or stale view, x
    ``(S, m, d)``.  The d ≤ 8 and exact big-d rows are held against the
    float64 φ on the first LANE_ROWS rows of every lane (the float32 plain
    version sums long chains, and at h = 1 the self-pairs ride the Gram
    diagonal's cancellation), the bf16x3 row against its plain version at
    the full shape; every row prints the plain version's distance from the
    float64 φ, is timed beside its bound and checks the wrapper's scratch.
    Raises on a failed row."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.ops.kernels import RBF
    from dist_svgd_torch.ops.svgd import phi

    fns = {"phi_small_d": (cuda_svgd.phi_small_d_cuda, cuda_svgd.phi_small_d_plain),
           "phi_big_d": (cuda_svgd.phi_big_d_cuda, cuda_svgd.phi_big_d_plain),
           "phi_big_d_bf16x3": (cuda_svgd.phi_big_d_bf16x3_cuda,
                                cuda_svgd.phi_big_d_bf16x3_plain),
           "phi_wide_d": (cuda_svgd.phi_wide_d_cuda, cuda_svgd.phi_big_d_plain)}
    for seed, (name, (S, k, m, d), h, own_rows, role) in enumerate(LANE_CASES,
                                                                    start=LANE_SEED):
        kern, plain = fns[name]
        g = torch.Generator(device="cpu").manual_seed(seed)
        x = torch.randn(S, m, d, generator=g).cuda()
        s = torch.randn(S, m, d, generator=g).cuda()
        # the lagged view holds the own block in its first rows; a ring hop
        # meets another shard's block
        y = (x[:, :k] if own_rows else torch.randn(S, k, d, generator=g).cuda()).contiguous()
        got = kern(y, x, s, h)
        torch.cuda.synchronize()
        ys = y[:, :LANE_ROWS].contiguous()
        exact = phi(ys.double(), x.double(), s.double(), RBF(h))
        plain_rows = plain(ys, x, s, h)
        vs_f64 = float((got[:, :LANE_ROWS].double() - exact).abs().max())
        if name == "phi_big_d_bf16x3":
            want = plain(y, x, s, h)
            err, scale, reference = float((got - want).abs().max()), float(
                want.abs().max()), "plain"
            del want
        else:
            err, scale, reference = vs_f64, float(exact.abs().max()), "phi f64"
        tol = KERNEL_RTOL * scale
        ok = bool(torch.isfinite(got).all()) and err <= tol
        b_ms, b_by = bound_ms(*phi_work(name, S, k, m, d, x.numel()))
        row = {"phase": "kernel_parity", "kernel": name, "role": role, "shape": [S, k, m, d],
               "x_lanes": S, "bandwidth": h, "reference": reference, "rows": min(k, LANE_ROWS),
               "max_abs_err": err, "max_abs_ref": scale, "tolerance": tol, "ok": ok,
               "max_abs_err_vs_f64": vs_f64,
               "plain_max_abs_err_vs_f64": float((plain_rows.double() - exact).abs().max()),
               "ms": cuda_ms(lambda: kern(y, x, s, h), TIMED_LAUNCHES),
               "plain_ms": cuda_ms(lambda: plain(y, x, s, h), OTHER_LAUNCHES),
               "bound_us": 1e3 * b_ms, "bound_by": b_by,
               "m_splits": cuda_svgd.split_count(name, S, k, m, x.device, d=d)}
        row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        if name != "phi_small_d":
            row["scratch_bytes"] = check_scratch(name, S, k, m, d, S)
        emit(row)
        del got, exact, plain_rows, x, y, s
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} vs the {reference} > {tol}")


def ring_ot_rows():
    """The Sinkhorn kernels at the 100k ring's block-pairing solve (RING_OT:
    8 lanes of 12,500 rows against 12,500, the fused route): the soft
    c-transform of every dual-advance start, held against the plain version
    in float64 on the first LANE_ROWS rows of every lane (SOFT_CT_TOL), and
    the Gibbs kernel held elementwise against the float32 plain version on
    those rows (KEXP_RTOL, its float64 distance printed); each timed at the
    full shape beside its bound.  Raises on a failed row."""
    import torch

    from dist_svgd_torch.ops import cuda_ot

    for name, (S, k, m, d), role, seed in RING_OT:
        rows, cols, f, gpot, _, _ = ot_inputs(S, k, m, d, seed)
        sub = rows[:, :LANE_ROWS].contiguous()
        if name == "ot_ctransform":
            kern = lambda: cuda_ot.ctransform_reduce_cuda(rows, cols, gpot, soft=True)  # noqa: E731
            plain = lambda: cuda_ot.ctransform_reduce_plain(rows, cols, gpot, soft=True)  # noqa: E731
            got = kern()[:, :LANE_ROWS]
            exact = cuda_ot.ctransform_reduce_plain(sub.double(), cols.double(),
                                                    gpot.double(), soft=True)
            plain32 = cuda_ot.ctransform_reduce_plain(sub, cols, gpot, soft=True)
            ok, err, tol, scale = ot_check(name, got.double(), exact, soft=True)
            opts = {"soft": True}
        else:
            kern = lambda: cuda_ot.kexp_cuda(rows, cols, f, gpot)  # noqa: E731
            plain = lambda: cuda_ot.kexp_plain(rows, cols, f, gpot)  # noqa: E731
            got = kern()[:, :LANE_ROWS]
            fs = f[:, :LANE_ROWS].contiguous()
            plain32 = cuda_ot.kexp_plain(sub, cols, fs, gpot)
            exact = cuda_ot.kexp_plain(sub.double(), cols.double(), fs.double(),
                                       gpot.double())
            ok, err, tol, scale = ot_check(name, got, plain32)
            opts = {}
        torch.cuda.synchronize()
        b_ms, b_by = bound_ms(*ot_work(name, S, k, m, d, **opts))
        row = {"phase": "kernel_parity", "kernel": name, "role": role, "shape": [S, k, m, d],
               **opts, "rows": LANE_ROWS,
               "reference": "plain f64" if name == "ot_ctransform" else "plain",
               "max_abs_err": err, "max_abs_ref": scale, "tolerance": tol, "ok": ok,
               "max_abs_err_vs_f64": float((got.double() - exact).abs().max()),
               "plain_max_abs_err_vs_f64": float((plain32.double() - exact).abs().max()),
               "ms": cuda_ms(kern, MAIN_100K_LAUNCHES), "plain_ms": cuda_ms(plain, PLAIN_100K_REPS),
               "bound_us": 1e3 * b_ms, "bound_by": b_by}
        row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        emit(row)
        del got, exact, plain32, rows, cols, f, gpot
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} > {tol}")


def resumable_phases(data, init, x_test, t_test):
    """The resumable, budgeted paths on the card (the constants above
    LANE_CASES):
    the ring north star, the port's tools/large_n.py at 100k monolithic and
    chunked, the 10k fused route chunked, the checkpoint round trip, the
    lagged Covertype and BNN drivers, the Covertype cadences and resume,
    and the 100k ring step's pair rate.  Each phase's launch counts are set
    to 0 just before it and read just after; a phase that fails raises.
    Returns the measured pairs a second."""
    import os
    import shutil

    import numpy as np
    import torch

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.experiments import bnn as bnn_drv
    from dist_svgd_torch.experiments import covertype as cov
    from dist_svgd_torch.models.logreg import ensemble_test_accuracy, logreg_logp
    from dist_svgd_torch.ops import cuda_ot, cuda_svgd
    from dist_svgd_torch.parallel import exchange
    from dist_svgd_torch.tools import large_n
    from dist_svgd_torch.utils import checkpoint as ckpt
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    ns = NORTH_STAR
    d = init.shape[1]
    card = smi("name,power.limit")

    def reset_counts():
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        cuda_ot.reset_launch_counts()

    def counts():
        torch.cuda.synchronize()
        return {**cuda_svgd.launch_counts, **cuda_ot.launch_counts}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- ring north star: ring against gather, both all_* modes ----------
    for mode, exch_s in (("all_particles", False), ("all_scores", True)):
        row = {"phase": "ring_north_star", "mode": mode, "n": ns["n"], "shards": ns["shards"],
               "d": d, "steps": RING_STEPS, "card": card}
        out = {}
        for impl in ("gather", "ring"):
            rds = DistSampler(ns["shards"], logreg_logp, None, init, data=data,
                              exchange_particles=True, exchange_scores=exch_s,
                              include_wasserstein=False, exchange_impl=impl)
            rds.run_steps(3, ns["step_size"])  # warm: the same 3 steps in both
            reset_counts()
            _, sec = timed(lambda: rds.run_steps(RING_STEPS, ns["step_size"]))
            launched = counts()
            row[f"{impl}_ms_per_step"] = 1e3 * sec / RING_STEPS
            row[f"{impl}_phi_launches_per_step"] = launched["phi_small_d"] / RING_STEPS
            out[impl] = rds.particles
        dev = float((out["ring"] - out["gather"]).abs().max())
        bound = TRAJ_RTOL * float(out["gather"].abs().max())
        ok = (bool(torch.isfinite(out["ring"]).all()) and dev <= bound
              and row["ring_phi_launches_per_step"] == ns["shards"]
              and row["gather_phi_launches_per_step"] == 1)
        row.update(max_abs_dev=dev, bound=bound, ok=ok)
        emit(row)
        if not ok:
            raise AssertionError(f"ring north star {mode}: {row}")

    # ---- large_n: the port's tool at 100k, ring and gather, budgeted ------
    ln = LARGE_N
    base = ["--n", str(ln["n"]), "--shards", str(ln["shards"]), "--w2", "--ab",
            "--steps", str(ln["steps"]), "--samples", str(ln["samples"]),
            "--pairs-per-sec", str(ln["pairs_per_sec"])]
    device = torch.device("cuda")
    for impl, route in (("ring", "fused"), ("gather", "streaming")):
        args = large_n.build_parser().parse_args(
            base + ["--exchange-impl", impl, "--dispatch-budget", str(ln["budget"][impl])])
        reset_counts()
        records = large_n.run_w2(args, device)
        launched = counts()
        by_exec = {r["execution"]: r for r in records}
        chunked = by_exec["chunked"]
        want = ["phi_small_d", "ot_ctransform"] + (
            ["ot_kexp"] if route == "fused" else ["ot_kmat_vec", "ot_plan_grad"])
        # a chunked W2 step: the split solve's dispatches, the φ and the finish
        w2_dispatches = chunked["dispatches_per_step"] - (2 if impl == "ring" else 1)
        ok = (chunked["plan"] == "intra_step" and w2_dispatches >= 2
              and all(launched[k] > 0 for k in want)
              and (launched["ot_kexp"] == 0) == (route == "streaming"))
        row = {"phase": "large_n_ring_w2" if impl == "ring" else "large_n_gather_w2",
               "n": ln["n"], "shards": ln["shards"], "route": route,
               "w2_pairing": chunked["w2_pairing"], "records": records,
               "ms_per_step": {e: 1e3 * r["wall_per_step_s"] for e, r in by_exec.items()},
               "dispatches_per_step": {e: r["dispatches_per_step"] for e, r in by_exec.items()},
               "max_dispatch_wall_s": {e: r["max_dispatch_wall_s"] for e, r in by_exec.items()},
               "w2_dispatches_per_step": w2_dispatches, "launches": launched,
               "card": card, "ok": ok}
        if impl == "ring":  # the two executions from one state, at a converging solve
            args.sinkhorn_iters = ln["parity_iters"]
            finals = {}
            for label, kw in (("monolithic", {}),
                              ("chunked", dict(dispatch_budget=ln["budget"][impl],
                                               pairs_per_sec=ln["pairs_per_sec"]))):
                pds = large_n.w2_sampler(args, device)
                pds._sinkhorn["sinkhorn_tol"] = None
                pds.run_steps(ln["parity_steps"], args.stepsize, h=10.0, **kw)
                finals[label] = pds.particles
                del pds
            dev = float((finals["chunked"] - finals["monolithic"]).abs().max())
            bound = TRAJ_RTOL * float(finals["monolithic"].abs().max())
            row.update(parity_steps=ln["parity_steps"], parity_iters=ln["parity_iters"],
                       max_abs_dev=dev, bound=bound)
            row["ok"] = ok = ok and bool(torch.isfinite(finals["chunked"]).all()) and dev <= bound
            del finals
        emit(row)
        if not ok:
            raise AssertionError(f"large_n {impl}: {row}")
        torch.cuda.empty_cache()

    # ---- the 10k fused route with its solve split --------------------------
    wc = W2_CHUNKED
    rows = {}
    for label, kw in (("monolithic", {}), ("chunked", dict(max_passes_per_dispatch=wc["max_passes"]))):
        wds = DistSampler(ns["shards"], logreg_logp, None, init, data=data,
                          exchange_particles=True, exchange_scores=False,
                          include_wasserstein=True, wasserstein_solver="sinkhorn",
                          sinkhorn_tol=None)
        wds.run_steps(2, ns["step_size"], h=10.0)
        reset_counts()
        _, sec = timed(lambda: wds.run_steps(wc["steps"], ns["step_size"], h=10.0, **kw))
        rows[label] = {"ms_per_step": 1e3 * sec / wc["steps"], "launches": counts(),
                       "stats": wds.last_run_stats, "particles": wds.particles}
    dev = float((rows["chunked"]["particles"] - rows["monolithic"]["particles"]).abs().max())
    bound = TRAJ_RTOL * float(rows["monolithic"]["particles"].abs().max())
    launched = rows["chunked"]["launches"]
    ok = (dev <= bound and launched["ot_kexp"] > 0 and launched["ot_ctransform"] > 0
          and rows["chunked"]["stats"]["execution"] == "intra_step")
    emit({"phase": "w2_chunked_north_star", "n": ns["n"], "shards": ns["shards"],
          "steps": wc["steps"], "max_passes_per_dispatch": wc["max_passes"],
          "ms_per_step": {k: v["ms_per_step"] for k, v in rows.items()},
          "dispatches_per_step": rows["chunked"]["stats"]["dispatches_per_step"],
          "launches": launched, "max_abs_dev": dev, "bound": bound, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"w2 chunked north star: dev {dev} launches {launched}")
    del rows

    # ---- checkpoint round trip of a 100k W2 streaming run -------------------
    cp = CHECKPOINT
    init100k = init_particles_per_shard(0, W2_STREAMING["n"], d, ns["shards"])

    def streaming(S=ns["shards"]):
        return DistSampler(S, logreg_logp, None, init100k, data=data,
                           exchange_particles=True, exchange_scores=False,
                           include_wasserstein=True, wasserstein_solver="sinkhorn")

    ref = streaming()
    ref.run_steps(cp["steps"], ns["step_size"], h=W2_STREAMING["h"])
    root = os.path.join("build", "chip_smoke_ckpt")
    mgr = ckpt.CheckpointManager(root, every=cp["save_at"])
    mgr.clear()
    a = streaming()
    reset_counts()
    a.run_steps(cp["save_at"], ns["step_size"], h=W2_STREAMING["h"])
    launched = counts()
    state, state_s = timed(a.state_dict)
    path, save_s = timed(lambda: mgr.save(cp["save_at"], state))
    nbytes = os.path.getsize(os.path.join(path, "state.npz"))
    del a
    b = streaming()
    loaded, load_s = timed(mgr.restore_latest)
    _, restore_s = timed(lambda: b.load_state_dict(loaded))
    b.run_steps(cp["steps"] - cp["save_at"], ns["step_size"], h=W2_STREAMING["h"])
    bitwise = bool(torch.equal(b.particles, ref.particles))
    c = streaming(cp["reshard_to"])
    c.load_state_dict(loaded)
    resharded = (tuple(c._previous.shape), c._w2_g is None)
    c.run_steps(2, ns["step_size"], h=W2_STREAMING["h"])
    ok = (bitwise and bool(torch.isfinite(c.particles).all())
          and resharded == ((cp["reshard_to"], W2_STREAMING["n"], d), True)
          and launched["ot_kmat_vec"] > 0 and launched["ot_plan_grad"] > 0)
    emit({"phase": "checkpoint_roundtrip", "n": W2_STREAMING["n"], "shards": ns["shards"],
          "saved_at": cp["save_at"], "steps": cp["steps"], "bitwise": bitwise,
          "state_dict_ms": 1e3 * state_s, "save_ms": 1e3 * save_s, "load_ms": 1e3 * load_s,
          "load_state_dict_ms": 1e3 * restore_s, "npz_bytes": nbytes,
          "bytes": {k: int(v.nbytes) for k, v in loaded.items()
                    if k in ("particles", "previous", "w2_g")},
          "resharded_to": cp["reshard_to"], "resharded_previous": list(resharded[0]),
          "dual_cold": resharded[1], "launches": launched, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"checkpoint round trip: bitwise={bitwise} {resharded}")
    del ref, b, c, loaded, state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- Covertype lagged (--exchange-every 4), both tiers -------------------
    gathers = {"n": 0}
    real_gather = exchange.all_gather

    def counting_gather(blocks):
        gathers["n"] += 1
        return real_gather(blocks)

    cl = CT_LAGGED
    exchange.all_gather = counting_gather
    try:
        for tier, kernel in (("cuda_bf16", "phi_big_d_bf16x3"), ("cuda", "phi_big_d")):
            gathers["n"] = 0
            reset_counts()
            final, metrics = cov.run(niter=cl["niter"], exchange_every=cl["exchange_every"],
                                     phi_impl=tier)
            launched = counts()
            ok = (bool(np.isfinite(final).all())
                  and launched == {**launched, **phi_counts(**{kernel: cl["niter"]})}
                  and gathers["n"] == cl["niter"] // cl["exchange_every"])
            emit({"phase": "covertype_lagged", **metrics,
                  "ms_per_step": 1e3 * metrics["wall_s"] / cl["niter"],
                  "gathers_per_step": gathers["n"] / cl["niter"], "launches": launched,
                  "card": card, "ok": ok})
            if not ok:
                raise AssertionError(f"covertype lagged {tier}: {launched} {gathers}")
    finally:
        exchange.all_gather = real_gather

    # ---- Covertype cadences and a resume ----------------------------------
    cc = CT_CADENCES
    out_dir = os.path.join("build", "chip_smoke_cadences")
    shutil.rmtree(out_dir, ignore_errors=True)
    ck_dir, log_path = os.path.join(out_dir, "ckpt"), os.path.join(out_dir, "metrics.jsonl")
    os.makedirs(out_dir)
    reset_counts()
    final, metrics = cov.run(niter=cc["niter"], checkpoint_every=cc["checkpoint_every"],
                             checkpoint_dir=ck_dir, log_every=cc["log_every"],
                             metrics_path=log_path,
                             profile_dir=os.path.join(out_dir, "profile"))
    launched = counts()
    lines = [json.loads(ln) for ln in open(log_path)]
    steps_saved = sorted(os.listdir(ck_dir))
    # the newest checkpoint set aside: the resume starts from the one before
    newest = os.path.join(ck_dir, f"step_{cc['niter']}")
    shutil.move(newest, os.path.join(out_dir, "newest"))
    resumed, rmetrics = cov.run(niter=cc["niter"], resume=True, checkpoint_dir=ck_dir)
    d_ct = final.shape[1]
    trace = os.path.join(out_dir, "profile", "trace.json")
    ok = (all(set(ln) == JSONL_KEYS for ln in lines)
          and [ln["step"] for ln in lines] == list(range(cc["log_every"], cc["niter"] + 1,
                                                         cc["log_every"]))
          and rmetrics["resumed_from"] == cc["niter"] - cc["checkpoint_every"]
          and np.array_equal(resumed, final) and os.path.getsize(trace) > 0
          # the resolved tier's kernel: a warm-up step and every step
          and launched[cuda_svgd.kernel_for(
              d_ct, "bf16" if metrics["phi_impl"] == "cuda_bf16" else "f32")] == cc["niter"] + 1)
    emit({"phase": "covertype_cadences", "niter": cc["niter"],
          "checkpoint_every": cc["checkpoint_every"], "log_every": cc["log_every"],
          "jsonl_lines": lines, "jsonl_keys_match_jax": all(set(ln) == JSONL_KEYS for ln in lines),
          "checkpoints": steps_saved, "resumed_from": rmetrics["resumed_from"],
          "resume_bitwise": bool(np.array_equal(resumed, final)),
          "trace_bytes": os.path.getsize(trace), "test_acc": metrics["test_acc"],
          "wall_s": metrics["wall_s"], "launches": launched, "card": card, "ok": ok})
    if not ok:
        raise AssertionError("covertype cadences failed")
    shutil.rmtree(out_dir, ignore_errors=True)

    # ---- BNN lagged (--nproc 8 --exchange-every 5), the exact tier ---------
    bl = BNN_LAGGED
    reset_counts()
    final, metrics = bnn_drv.run(nproc=bl["nproc"], exchange_every=bl["exchange_every"],
                                 niter=bl["niter"], phi_impl="cuda")
    launched = counts()
    ok = (bool(np.isfinite(final).all())
          and launched == {**launched, **phi_counts(phi_wide_d=bl["niter"])})
    emit({"phase": "bnn_lagged", **metrics, "ms_per_step": 1e3 * metrics["wall_s"] / bl["niter"],
          "launches": launched, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"bnn lagged: {launched}")

    # ---- the pairs/s of the 100k ring step ---------------------------------
    pr = PAIRS_RATE
    rds = DistSampler(pr["shards"], logreg_logp, None,
                      init_particles_per_shard(0, pr["n"], d, pr["shards"]), data=data,
                      exchange_particles=True, exchange_scores=False, include_wasserstein=False,
                      exchange_impl="ring")
    rds.run_steps(pr["warm_steps"], ns["step_size"])
    reset_counts()
    _, sec = timed(lambda: rds.run_steps(pr["steps"], ns["step_size"]))
    launched = counts()
    rate = float(pr["n"]) ** 2 * pr["steps"] / sec
    emit({"phase": "dispatch_pairs_per_sec", "n": pr["n"], "shards": pr["shards"],
          "steps": pr["steps"], "ms_per_step": 1e3 * sec / pr["steps"], "pairs_per_sec": rate,
          "launches": launched, "card": card,
          "test_accuracy": float(ensemble_test_accuracy(rds.particles, x_test, t_test))})
    if not launched["phi_small_d"] == pr["shards"] * pr["steps"]:
        raise AssertionError(f"pairs rate: launches {launched}")
    return rate


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


def telemetry_phase(init, data, card):
    """The north star under the tracer: a budgeted run_steps planning two
    whole-step dispatches, traced and untraced in turns (untraced, traced,
    traced, untraced).  Checks the span counts against the dispatches, the
    kernel launches, and that the Chrome export parses."""
    import os

    import torch

    from dist_svgd_torch import DistSampler, telemetry
    from dist_svgd_torch.distsampler import DISPATCH_PAIRS_PER_SEC
    from dist_svgd_torch.models.logreg import logreg_logp
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.utils.metrics import StepTimer

    ns, tm = NORTH_STAR, TELEMETRY
    budget = tm["chunk"] * float(ns["n"]) ** 2 / DISPATCH_PAIRS_PER_SEC
    walls = {"untraced": [], "traced": []}
    row = {"phase": "telemetry_north_star", "n": ns["n"], "shards": ns["shards"],
           "steps": tm["steps"], "dispatch_budget_s": budget, "card": card}
    for label in ("untraced", "traced", "traced", "untraced"):
        tds = DistSampler(ns["shards"], logreg_logp, None, init, data=data,
                          exchange_particles=True, exchange_scores=False,
                          include_wasserstein=False)
        tds.run_steps(3, ns["step_size"])
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        tracer = telemetry.enable() if label == "traced" else None
        try:
            timer = StepTimer(span_name="train.run")
            tds.run_steps(tm["steps"], ns["step_size"], dispatch_budget=budget)
            sec = timer.mark(tds.particles)
        finally:
            if tracer is not None:
                telemetry.disable()
        launched = dict(cuda_svgd.launch_counts)
        stats = tds.last_run_stats
        walls[label].append(1e3 * sec / tm["steps"])
        ok = (stats["execution"] == "scan_chunks" and stats["num_dispatches"] >= 2
              and launched == phi_counts(phi_small_d=tm["steps"])
              and bool(torch.isfinite(tds.particles).all()))
        if tracer is not None:
            counts = tracer.counts()
            os.makedirs(os.path.join("build", "chip_smoke_telemetry"), exist_ok=True)
            path = os.path.join("build", "chip_smoke_telemetry", "north_star.trace.json")
            n_events = tracer.export_chrome(path)
            with open(path) as fh:
                doc = json.load(fh)
            ok = ok and (counts.get("train.step_chunk") == stats["num_dispatches"]
                         and counts.get("train.run") == 1
                         and len(doc["traceEvents"]) == n_events
                         and doc["otherData"]["process"]["pid"] == os.getpid())
            row.update(span_counts=counts, chrome_events=n_events,
                       dropped_events=tracer.dropped_events)
        row.update(num_dispatches=stats["num_dispatches"], launches=launched)
        if not ok:
            emit({**row, "ok": False})
            raise AssertionError(f"telemetry north star ({label}): {stats} {launched} {row}")
    row.update(ms_per_step=walls, ok=True,
               traced_over_untraced=sum(walls["traced"]) / sum(walls["untraced"]))
    emit(row)


def diagnostics_phase(ds, data, card):
    """PosteriorDiagnostics on the north star's final particles (float32
    against float64 on the card), then the Covertype and BNN ensembles at
    the defaults, with ensemble_health and ReloadPolicy."""
    import numpy as np
    import torch

    from dist_svgd_torch.experiments import bnn as bnn_drv
    from dist_svgd_torch.experiments import covertype as cov
    from dist_svgd_torch.models.logreg import logreg_logp
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.telemetry import (DiagnosticsConfig, MetricsRegistry,
                                           PosteriorDiagnostics, ReloadPolicy,
                                           ensemble_health)

    dg = DIAG
    parts = ds.particles
    full = tuple(a.cuda() for a in data)
    scores = torch.func.vmap(torch.func.grad(lambda th: logreg_logp(th, full)))(parts)
    cfg = DiagnosticsConfig(max_points=dg["max_points"])
    reg = MetricsRegistry()
    pd = PosteriorDiagnostics(cfg, registry=reg)
    walls = []
    for step in range(dg["computes"]):
        rep32 = pd.compute(parts, scores=scores, num_shards=dg["shards"], step=step)
        walls.append(rep32["wall_s"])
    rep64 = PosteriorDiagnostics(cfg, registry=MetricsRegistry()).compute(
        parts.double(), scores=scores.double(), num_shards=dg["shards"])
    keys = ("ksd", "ksd_sq", "ess", "min_pairwise_dist", "median_pairwise_dist",
            "min_dim_var", "shard_mean_div", "shard_var_div")
    rel = {k: abs(rep32[k] - rep64[k]) / max(abs(rep64[k]), 1e-30) for k in keys}
    ok = (all(np.isfinite(rep32[k]) for k in keys) and rep32["n_eval"] == parts.shape[0]
          and rel["ksd"] <= dg["rtol"] and rel["ess"] <= dg["rtol"]
          and reg.gauge("svgd_diag_ksd").value() == rep32["ksd"])
    emit({"phase": "diagnostics", "ensemble": "north_star", "n": parts.shape[0],
          "d": parts.shape[1], "max_points": dg["max_points"], "shards": dg["shards"],
          "compute_wall_s": walls, "f32": {k: rep32[k] for k in keys},
          "f64": {k: rep64[k] for k in keys}, "rel_dev": rel, "bound": dg["rtol"],
          "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"diagnostics north star: rel {rel}")

    def judge(name, particles, extra):
        rep = PosteriorDiagnostics(registry=MetricsRegistry()).compute(
            particles, num_shards=extra.pop("shards", None))
        health = ensemble_health(particles)
        policy = ReloadPolicy()
        collapsed = particles[:1].expand_as(particles).contiguous()
        rejected = policy.judge(ensemble_health(collapsed), health)
        ok = (all(np.isfinite(v) for v in rep.values() if isinstance(v, float))
              and bool(rejected))
        emit({"phase": "diagnostics", "ensemble": name, **extra, "report": rep,
              "health": health, "admitted": policy.judge(health, None) == [],
              "collapsed_rejected": rejected, "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"diagnostics {name}: {rep} {rejected}")

    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    cds, _, info = cov.make_sampler(phi_impl="cuda")
    cds.run_steps(dg["ct_steps"], COVERTYPE["step_size"])
    torch.cuda.synchronize()
    launched_ct = dict(cuda_svgd.launch_counts)
    if launched_ct != phi_counts(phi_big_d=dg["ct_steps"]):
        raise AssertionError(f"diagnostics covertype launches {launched_ct}")
    judge("covertype", cds.particles, {"n": info["n_used"], "d": cds.particles.shape[1],
                                       "steps": dg["ct_steps"], "shards": cds._num_shards,
                                       "launches": launched_ct})
    del cds
    cuda_svgd.reset_launch_counts()
    final, metrics = bnn_drv.run(niter=dg["bnn_niter"])
    torch.cuda.synchronize()
    launched_bnn = dict(cuda_svgd.launch_counts)
    if launched_bnn != phi_counts(phi_wide_d=dg["bnn_niter"]):
        raise AssertionError(f"diagnostics bnn launches {launched_bnn}")
    judge("bnn", torch.as_tensor(final, device="cuda"),
          {"n": final.shape[0], "d": final.shape[1], "steps": dg["bnn_niter"],
           "test_rmse": metrics["test_rmse"], "launches": launched_bnn})


def large_n_approx_phase(card):
    """tools/large_n.py's large_n_approx row for both methods at n =
    100,000: within its budget, active, and the exact probe on
    phi_small_d."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.tools import large_n

    a = APPROX_LARGE_N
    for method in ("rff", "nystrom"):
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        row = large_n.run_approx_row(
            a["n"], method=method, num_features=a["dial"], num_landmarks=a["dial"],
            steps=a["steps"], samples=a["samples"], pin_n=a["pin_n"],
            exact_probe_n=a["exact_probe_n"], device="cuda")
        torch.cuda.synchronize()
        launched = dict(cuda_svgd.launch_counts)
        gate_ok, why = large_n.approx_row_ok(row)
        probe_launches = (1 + a["samples"]) * a["steps"]
        ok = gate_ok and launched == phi_counts(phi_small_d=probe_launches)
        emit({"phase": "large_n_approx", **row, "launches": launched,
              "ms_per_step": 1e3 * row["wall_per_step_s"],
              "exact_probe_ms_per_step": 1e3 * row["exact_probe_wall_per_step_s"],
              "gate": why, "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"large_n_approx {method}: {why} launches {launched}")


def crossover_factor_needed(rungs, feature_counts):
    """The smallest crossover factor the ladder allows, per series and in
    all: 'auto' switches a series with F features at n = 2·factor·F, which
    must be at or above the first rung after the series' last rung that was
    not faster (``(n, False)`` ends the run of wins), or above the top rung
    when that one was not faster.  Returns ``(factor, strict)``: the factor
    must be ``>= factor``, or ``> factor`` where ``strict``."""
    need, strict = 0.0, False
    for name, series in rungs.items():
        f2 = 2.0 * feature_counts[name]
        slow = [n for n, faster in series if not faster]
        if not slow:
            req, req_strict = series[0][0] / f2, False
        elif slow[-1] == series[-1][0]:
            req, req_strict = slow[-1] / f2, True
        else:
            req, req_strict = min(n for n, _ in series if n > slow[-1]) / f2, False
        if req > need or (req == need and req_strict):
            need, strict = req, req_strict
    return need, strict


def approx_crossover_phase(card):
    """The 'auto' crossover's ladder: the exact φ against phi_rff and
    phi_nystrom at k = m = n.  Prints each rung, then the smallest factor
    the ladder allows beside the committed one; fails when the committed
    factor would take a series approximate where it was not measured
    faster (:func:`crossover_factor_needed`)."""
    import torch

    from dist_svgd_torch.ops import approx, cuda_svgd
    from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
    from dist_svgd_torch.ops.kernels import RBF, median_bandwidth
    from dist_svgd_torch.utils.rng import approx_bank_seed, init_particles

    cr = CROSSOVER
    series, feature_counts = {}, {}
    torch.cuda.synchronize()
    cuda_svgd.reset_launch_counts()
    for n in cr["ns"]:
        x = 2.5 * init_particles(0, n, cr["d"], device="cuda") + 1.5
        y, s = x[None], -x[None]
        h = float(median_bandwidth(x))
        exact_fn = resolve_phi_fn(RBF(h), "auto")
        exact = exact_fn(y, x, s)
        row = {"phase": "approx_crossover", "n": n, "d": cr["d"], "bandwidth": h,
               "exact_ms": cuda_ms(lambda: exact_fn(y, x, s), cr["reps"]), "card": card}
        for dial in cr["dials"]:
            for method in ("rff", "nystrom"):
                spec = approx.KernelApprox(method, num_features=dial, num_landmarks=dial,
                                           seed=approx_bank_seed(0))
                fn = approx.make_approx_phi_fn(RBF(h), spec)
                err = approx.phi_rel_error(exact, fn(y, x, s))
                ms = cuda_ms(lambda: fn(y, x, s), cr["reps"])
                faster = ms < (1.0 - cr["margin"]) * row["exact_ms"]
                name = f"{method}_{dial}"
                series.setdefault(name, []).append((n, faster))
                feature_counts[name] = spec.feature_count
                row[name] = {"ms": ms, "rel_err": err, "faster": faster,
                             "auto_picks": approx.approx_preferred(n, n, spec.feature_count)}
                if not err < 1.0:
                    raise AssertionError(f"approx crossover {method} {dial} at n={n}: "
                                         f"rel err {err}")
                del fn
            torch.cuda.empty_cache()
        emit(row)
        del x, y, s, exact
        torch.cuda.empty_cache()
    launched = dict(cuda_svgd.launch_counts)
    expect = sum(4 + cr["reps"] for _ in cr["ns"])  # one call, 3 warm, reps timed
    need, strict = crossover_factor_needed(series, feature_counts)
    factor = approx.APPROX_CROSSOVER_FACTOR
    consistent = factor > need if strict else factor >= need
    ok = consistent and launched == phi_counts(phi_small_d=expect)
    emit({"phase": "approx_crossover", "summary": True, "margin": cr["margin"],
          "factor_needed": need, "needed_strictly_above": strict,
          "committed_factor": factor, "consistent": consistent,
          "launches": launched, "card": card, "ok": ok})
    if not consistent:
        raise AssertionError(f"approx crossover: committed factor {factor} against the "
                             f"ladder's {'>' if strict else '>='} {need}")
    if launched != phi_counts(phi_small_d=expect):
        raise AssertionError(f"approx crossover: exact launches {launched} != {expect}")


def approx_north_star_phase(init, data, card):
    """The north star with kernel_approx: RFF under 'auto' and 'torch' and
    Nyström under 'torch', timed, with the residual gauges; then 20 steps
    of the card's float32 RFF run against the CPU's float64 one on the
    same bank (drawn on the CPU from the run seed)."""
    import numpy as np
    import torch

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.models.logreg import logreg_logp
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.ops.approx import KernelApprox
    from dist_svgd_torch.telemetry import MetricsRegistry

    ns, an = NORTH_STAR, APPROX_NS

    def make(spec, impl, particles=init, device=None):
        return DistSampler(ns["shards"], logreg_logp, None, particles, data=data,
                           exchange_particles=True, exchange_scores=False,
                           include_wasserstein=False, phi_impl=impl, kernel_approx=spec,
                           device=device)

    for method, impl in (("rff", "auto"), ("rff", "torch"), ("nystrom", "torch")):
        spec = KernelApprox(method, num_features=an["num_features"],
                            num_landmarks=an["num_landmarks"])
        ads = make(spec, impl)
        ads.run_steps(3, ns["step_size"])
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        t0 = time.perf_counter()
        ads.run_steps(an["steps"], ns["step_size"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = dict(cuda_svgd.launch_counts)
        active = ads.kernel_approx_active
        reg = MetricsRegistry()
        rep = ads.approx_residual(max_points=an["residual_points"], registry=reg)
        gauges = {k: reg.gauge(f"svgd_diag_{k}").value()
                  for k in ("phi_approx_rel_err", "phi_approx_budget",
                            "phi_approx_within_budget", "phi_approx_dial")}
        expect = phi_counts() if active else phi_counts(phi_small_d=an["steps"])
        ok = (launched == expect and bool(torch.isfinite(ads.particles).all())
              and all(np.isfinite(v) for v in gauges.values())
              and (impl == "auto" or active))
        emit({"phase": "approx_north_star", "method": method, "phi_impl": impl,
              "dial": spec.accuracy_dial, "active": active, "steps": an["steps"],
              "ms_per_step": 1e3 * sec / an["steps"], "launches": launched,
              "residual": rep, "gauges": gauges, "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"approx north star {method} {impl}: {launched} {rep}")
        del ads
    out = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        spec = KernelApprox("rff", num_features=an["num_features"])
        tds = make(spec, "torch", init.to(dtype), device)
        tds.run_steps(an["traj_steps"], ns["step_size"])
        out[device] = tds.particles.double().cpu()
    rel = float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max())
    ok = rel <= an["traj_rtol"]
    emit({"phase": "approx_north_star", "trajectory": "card f32 vs cpu f64",
          "method": "rff", "dial": an["num_features"], "steps": an["traj_steps"],
          "max_rel_dev": rel, "bound": an["traj_rtol"], "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"approx north star trajectory: {rel} > {an['traj_rtol']}")


def reshard_lane_rows():
    """phi_small_d at the lanes the supervised paths give it (RESHARD_LANES,
    h = 1, y the lanes' blocks of the shared x as in all_particles): held
    against the plain version at the full shape and against the float64 φ on
    the first LANE_ROWS rows of every lane, both within KERNEL_RTOL of their
    largest value; timed beside the bound.  Raises on a failed row."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.ops.kernels import RBF
    from dist_svgd_torch.ops.svgd import phi

    h = 1.0
    for seed, ((S, k, m, d), role) in enumerate(RESHARD_LANES, start=RESHARD_SEED):
        y, x, s = phi_inputs(S, k, m, d, seed)
        kern = lambda: cuda_svgd.phi_small_d_cuda(y, x, s, h)  # noqa: E731
        plain = lambda: cuda_svgd.phi_small_d_plain(y, x, s, h)  # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        ys = y[:, :LANE_ROWS].contiguous()
        exact = phi(ys.double(), x.double(), s.double(), RBF(h))
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        vs_f64, f64_scale = (float((got[:, :LANE_ROWS].double() - exact).abs().max()),
                             float(exact.abs().max()))
        ok = (bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
              and vs_f64 <= KERNEL_RTOL * f64_scale)
        b_ms, b_by = bound_ms(*phi_work("phi_small_d", S, k, m, d, x.numel()))
        row = {"phase": "kernel_parity", "kernel": "phi_small_d", "role": role,
               "shape": [S, k, m, d], "bandwidth": h, "reference": "plain and phi f64",
               "max_abs_err": err, "max_abs_plain": scale, "tolerance": KERNEL_RTOL * scale,
               "rows": min(k, LANE_ROWS), "max_abs_err_vs_f64": vs_f64,
               "f64_tolerance": KERNEL_RTOL * f64_scale,
               "plain_max_abs_err_vs_f64": float(
                   (want[:, :LANE_ROWS].double() - exact).abs().max()),
               "ok": ok, "ms": cuda_ms(kern, TIMED_LAUNCHES),
               "plain_ms": cuda_ms(plain, OTHER_LAUNCHES), "bound_us": 1e3 * b_ms,
               "bound_by": b_by,
               "m_splits": cuda_svgd.split_count("phi_small_d", S, k, m, x.device, d=d)}
        row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        emit(row)
        del got, want, exact, y, x, s, ys
        if not ok:
            raise AssertionError(f"phi_small_d {role}: max|Δ| {err} vs plain, {vs_f64} vs "
                                 f"the f64 φ, beyond {KERNEL_RTOL} of {scale} / {f64_scale}")


def serving_lane_rows():
    """The big-d φ kernels at the lanes the serving section's training
    paths give them (SERVING_LANES, h = 1, y the lanes' blocks of the shared
    x as in all_particles): held against the plain version at the full shape
    within KERNEL_RTOL of its largest value, the exact tier also against the
    float64 φ on every row (k ≤ LANE_ROWS); timed beside the bound.  Raises
    on a failed row."""
    import torch

    from dist_svgd_torch.ops import cuda_svgd

    fns = {"phi_big_d": (cuda_svgd.phi_big_d_cuda, cuda_svgd.phi_big_d_plain),
           "phi_big_d_bf16x3": (cuda_svgd.phi_big_d_bf16x3_cuda,
                                cuda_svgd.phi_big_d_bf16x3_plain)}
    h = 1.0
    for seed, (name, (S, k, m, d), role) in enumerate(SERVING_LANES, start=SERVING_SEED):
        y, x, s = phi_inputs(S, k, m, d, seed)
        kern_fn, plain_fn = fns[name]
        kern = lambda: kern_fn(y, x, s, h)  # noqa: E731
        plain = lambda: plain_fn(y, x, s, h)  # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
        row = {"phase": "kernel_parity", "kernel": name, "role": role, "shape": [S, k, m, d],
               "bandwidth": h, "max_abs_err": err, "max_abs_plain": scale,
               "tolerance": KERNEL_RTOL * scale}
        if name == "phi_big_d":
            ys = y[:, :LANE_ROWS].contiguous()
            exact = cuda_svgd.phi_big_d_plain(ys.double(), x.double(), s.double(), h)
            vs_f64, f64_scale = (float((got[:, :LANE_ROWS].double() - exact).abs().max()),
                                 float(exact.abs().max()))
            ok = ok and vs_f64 <= KERNEL_RTOL * f64_scale
            row.update(reference="plain and phi f64", rows=min(k, LANE_ROWS),
                       max_abs_err_vs_f64=vs_f64, f64_tolerance=KERNEL_RTOL * f64_scale,
                       plain_max_abs_err_vs_f64=float(
                           (want[:, :LANE_ROWS].double() - exact).abs().max()))
            del exact
        b_ms, b_by = bound_ms(*phi_work(name, S, k, m, d, x.numel()))
        row.update(ok=ok, ms=cuda_ms(kern, TIMED_LAUNCHES), plain_ms=cuda_ms(plain, OTHER_LAUNCHES),
                   bound_us=1e3 * b_ms, bound_by=b_by,
                   m_splits=cuda_svgd.split_count(name, S, k, m, x.device, d=d))
        row["exp_floor_ms"], row["clocks_sm_mhz"] = exp_floor_ms(S * k * m)
        row["scratch_bytes"] = check_scratch(name, S, k, m, d, 1)
        emit(row)
        del got, want, y, x, s
        if not ok:
            raise AssertionError(f"{name} {role}: {row}")


def _serving_counts():
    """(reset, read) of every hand kernel's launch counts, fenced."""
    import torch

    from dist_svgd_torch.ops import cuda_ot, cuda_svgd

    def reset():
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        cuda_ot.reset_launch_counts()

    def read():
        torch.cuda.synchronize()
        return {**cuda_svgd.launch_counts, **cuda_ot.launch_counts}

    return reset, read


def serve_covertype_phase(root, card):
    """serve_covertype at its defaults, then the served ensemble's card
    float32 predictions against a CPU float64 engine's (the constants above
    SERVING)."""
    import os

    import numpy as np
    import torch

    from dist_svgd_torch.experiments import serve_covertype as tsc
    from dist_svgd_torch.serving import PredictiveEngine
    from dist_svgd_torch.utils.datasets import load_covertype

    reset, read = _serving_counts()
    ckpt = os.path.join(root, "covertype-ckpt")
    reset()
    t0 = time.perf_counter()
    out = tsc.run(checkpoint_dir=ckpt)
    wall = time.perf_counter() - t0
    launched = read()
    train = out.pop("train")
    nrows = train["nrows"]
    x, _ = load_covertype(nrows, seed=0)
    x_test = x[-max(nrows // 10, 1):]
    card_eng = PredictiveEngine.from_checkpoint(ckpt, "logreg", max_bucket=128)
    cpu_eng = PredictiveEngine.from_checkpoint(ckpt, "logreg", max_bucket=128, device="cpu",
                                               dtype=torch.float64)
    chunks = range(0, len(x_test), 128)
    f32 = np.concatenate([card_eng.predict(x_test[i:i + 128].astype(np.float32))["mean"]
                          for i in chunks])
    f64 = np.concatenate([cpu_eng.predict(x_test[i:i + 128].astype(np.float64))["mean"]
                          for i in chunks])
    vs_f64 = float(np.max(np.abs(f32.astype(np.float64) - f64)))
    others = {k: v for k, v in launched.items() if k != "phi_big_d_bf16x3"}
    bst = out["metrics"]["batcher"]
    row = {"phase": "serve_covertype", **{k: v for k, v in out.items() if k != "metrics"},
           "bitwise": out["served_vs_direct_max_abs_dev"] == 0.0,
           "train": {k: train[k] for k in ("phi_impl", "niter", "nparticles", "nproc",
                                           "test_acc", "wall_s")},
           "launches": launched, "phase_wall_s": wall,
           "card_f32_vs_cpu_f64_max_abs_dev": vs_f64, "card_vs_f64_tol": CARD_VS_F64_TOL,
           "batcher": {k: bst[k] for k in ("requests", "batches", "batch_occupancy_mean",
                                           "latency_p50_ms", "latency_p99_ms",
                                           "device_p50_ms", "queue_wait_p50_ms")},
           "engine": {k: out["metrics"]["engine"][k] for k in (
               "bucket_hits", "bucket_misses", "compiled_buckets", "n_particles", "dtype")},
           "card": card}
    ok = (out["request_errors"] == [] and out["rows_served"] > 0
          and out["served_vs_direct_max_abs_dev"] <= SERVED_TOL
          and vs_f64 <= CARD_VS_F64_TOL and train["phi_impl"] == "cuda_bf16"
          and launched["phi_big_d_bf16x3"] >= train["niter"]
          and not any(others.values()))
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"serve_covertype: {row}")


def serve_bench_phase(card):
    """tools/serve_bench.py at its defaults, the open loop at half the
    closed loop's rps, --lanes 4, --dtype bfloat16, --tenants 3; no hand
    kernel launches in any of them (the predictive programs hold none)."""
    from dist_svgd_torch.tools import serve_bench

    reset, read = _serving_counts()
    reset()
    closed = serve_bench.run_bench()
    rows = {"closed": closed,
            "open": serve_bench.run_bench(open_rate=closed["value"] / 2),
            "lanes4": serve_bench.run_bench(lanes=4),
            "bf16": serve_bench.run_bench(dtype="bfloat16"),
            "tenants3": serve_bench.run_multitenant_bench(tenants=3)}
    launched = read()
    failed = []
    for variant, row in rows.items():
        ok = row["recompiles"] == 0 and row["sentry_compiles"] == 0 and row["value"] > 0
        if variant == "open":
            ok = ok and row["open_loop"]["completed"] + row["open_loop"]["shed"] == 500
        if variant == "bf16":
            ok = ok and row["dtype"] == "bfloat16" and row.get("dtype_speedup") is not None
        if variant == "tenants3":
            ok = (ok and row["evictions"] >= 1 and row["quota_sheds"] >= 1
                  and row["quota_probe"]["polite_served"])
        else:
            ok = ok and row["shed"] == 0
        row = {"phase": "serve_bench", "variant": variant, **row, "card": card, "ok": ok}
        emit(row)
        if not ok:
            failed.append(variant)
    if failed or any(launched.values()):
        raise AssertionError(f"serve_bench: failed {failed}, kernel launches {launched}")
    return {variant: row["value"] for variant, row in rows.items()}


def serve_buckets_phase(card):
    """Every bucket program of the 10,000 × 55 logreg engine, f32 and bf16:
    its CUDA graph against the eager function underneath it; the bf16 graphs
    also against the f32 engine's and, at the largest bucket, against the
    CPU's bf16 engine; and served against direct at request sizes 1..256
    (the constants above SERVING)."""
    import numpy as np
    import torch

    from dist_svgd_torch.models.logreg import posterior_predictive_prob
    from dist_svgd_torch.serving import PredictiveEngine

    n, f = SERVING["n"], SERVING["features"]
    rng = np.random.default_rng(SERVING_SEED)
    parts = rng.normal(size=(n, 1 + f)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts, max_bucket=256)
    eng16 = PredictiveEngine("logreg", parts, max_bucket=256, dtype=torch.bfloat16)
    buckets = eng.warmup()
    eng16.warmup()
    dev = eng.device
    reps = SERVING["bucket_reps"]

    def p50_ms(fn):
        for _ in range(3):
            fn()
        laps = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            laps.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(laps))

    def max_dev(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    def scale(out):
        return max(float(v.abs().max()) for v in out.values())

    rows, ok16 = [], True
    for b in buckets:
        prog, prog16 = eng._kernels[b], eng16._kernels[b]
        xt = torch.from_numpy(rng.normal(size=(b, f)).astype(np.float32))
        xd = xt.to(dev)
        (graph,) = prog._graphs.values()
        (graph16,) = prog16._graphs.values()
        got, got16 = prog(xt), prog16(xt)
        want = {k: v.to("cpu") for k, v in prog._fn(xd).items()}
        want16 = {k: v.to("cpu") for k, v in prog16._fn(xd).items()}
        vs_f32 = {k: float((got16[k] - got[k]).abs().max()) for k in got}
        ok16 = (ok16 and max_dev(got16, want16) <= BF16_ULP * scale(want16)
                and all(torch.allclose(got16[k], got[k], rtol=r, atol=a)
                        for k, (r, a) in BF16_VS_F32.items()))
        flops = 2 * b * n * f + 8 * b * n  # the product, the sigmoid, two reductions
        b_ms, b_by = bound_ms(flops, 4 * (n * (1 + f) + b * f + 2 * b))
        rows.append({"bucket": b, "graph_p50_ms": p50_ms(lambda: prog(xt)),
                     "eager_p50_ms": p50_ms(
                         lambda: {k: v.to("cpu") for k, v in prog._fn(xt.to(dev)).items()}),
                     "graph_event_ms": cuda_ms(graph.graph.replay, reps),
                     "eager_event_ms": cuda_ms(lambda: prog._fn(xd), reps),
                     "graph_vs_eager_max_abs": max_dev(got, want), "bound_us": 1e3 * b_ms,
                     "bound_by": b_by,
                     "bf16_graph_p50_ms": p50_ms(lambda: prog16(xt)),
                     "bf16_graph_event_ms": cuda_ms(graph16.graph.replay, reps),
                     "bf16_eager_event_ms": cuda_ms(lambda: prog16._fn(xd), reps),
                     "bf16_graph_vs_eager_max_abs": max_dev(got16, want16),
                     "bf16_vs_f32_max_abs": vs_f32})
    x = rng.normal(size=(256, f)).astype(np.float32)
    cpu16 = PredictiveEngine("logreg", parts, max_bucket=256, dtype=torch.bfloat16,
                             device="cpu").predict(x)
    card16 = eng16.predict(x)
    bf16_vs_cpu = max(float(np.max(np.abs(card16[k] - cpu16[k]))) for k in cpu16)
    bf16_cpu_tol = 2 * BF16_ULP * max(float(np.max(np.abs(v))) for v in cpu16.values())
    served_dev, bitwise = 0.0, True
    for b in SERVING["served_sizes"]:
        served = eng.predict(x[:b])["mean"]
        direct = posterior_predictive_prob(eng.particles, torch.from_numpy(x[:b]).to(dev)
                                           ).mean(0).cpu().numpy()
        served_dev = max(served_dev, float(np.max(np.abs(served - direct))))
        bitwise = bitwise and bool(np.array_equal(served, direct))
    ok = (served_dev <= SERVED_TOL and all(r["graph_vs_eager_max_abs"] <= SERVED_TOL
                                           for r in rows)
          and ok16 and bf16_vs_cpu <= bf16_cpu_tol)
    emit({"phase": "serve_buckets", "n": n, "d": 1 + f, "buckets": rows,
          "served_sizes": list(SERVING["served_sizes"]),
          "served_vs_direct_max_abs_dev": served_dev, "bitwise": bitwise,
          "tolerance": SERVED_TOL, "bf16_ulp": BF16_ULP, "bf16_vs_f32_tol": BF16_VS_F32,
          "bf16_card_vs_cpu_max_abs_dev": bf16_vs_cpu, "bf16_card_vs_cpu_tol": bf16_cpu_tol,
          "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"serve_buckets: served {served_dev}, bf16 vs cpu "
                             f"{bf16_vs_cpu}, rows {rows}")


def profiler_overhead_phase(card):
    """The dispatch profiler's and the usage meter's serve cost: JAX's
    closed-loop A/B printed with its rounds and their spread, and the
    instruments' added time a batch over the closed loop's batch rate held
    to JAX's gate (3%; serve_bench.measure_profiler_overhead says why)."""
    from dist_svgd_torch.tools import serve_bench

    row = serve_bench.measure_profiler_overhead(rounds=SERVING["ab_rounds"],
                                                requests=SERVING["ab_requests"])
    progs = row["programs"]
    ok = (row["rps_disabled"] > 0 and row["rps_enabled"] > 0 and row["within_gate"]
          and row["batches_per_s"] > 0
          and sum(p["dispatches"] for p in progs.values()) > 0
          and row["usage_totals"]["requests"] == SERVING["ab_requests"])
    emit({"phase": "profiler_overhead", **row, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"profiler_overhead: {row}")


def serve_hot_reload_phase(root, card):
    """Direct callers and two batcher lanes predicting on the 10,000 × 55
    engine while a CheckpointHotReloader swaps in a newer step: no errors,
    every answer one generation's, the swapped ensemble served after."""
    import os
    import threading

    import numpy as np

    from dist_svgd_torch.serving import CheckpointHotReloader, MicroBatcher, PredictiveEngine
    from dist_svgd_torch.utils.checkpoint import CheckpointManager

    n, f = SERVING["n"], SERVING["features"]
    rng = np.random.default_rng(SERVING_SEED + 1)
    gens = [rng.normal(size=(n, 1 + f)).astype(np.float32) for _ in range(2)]
    mgr = CheckpointManager(os.path.join(root, "reload"), every=1)
    mgr.save(1, {"particles": gens[0]})
    eng = PredictiveEngine.from_checkpoint(mgr.root, "logreg", max_bucket=256)
    eng.warmup()
    reloader = CheckpointHotReloader(eng, mgr.root)
    x = rng.normal(size=(16, f)).astype(np.float32)
    want = [eng.predict(x)["mean"],
            PredictiveEngine("logreg", gens[1], max_bucket=256).predict(x)["mean"]]
    bat = MicroBatcher(eng.predict, max_batch=256, lanes=2, max_wait_ms=0.5)
    results, errors = [], []
    start = threading.Barrier(SERVING["reload_threads"] + 1)
    swapped_event = threading.Event()

    def hammer(direct):
        # predict until the swap, then reload_calls more
        try:
            start.wait(timeout=60)
            after = 0
            while after < SERVING["reload_calls"]:
                done = swapped_event.is_set()
                out = eng.predict(x) if direct else bat.submit(x).result(timeout=60)
                results.append(out["mean"])
                after += done
        except Exception as e:  # surfaced below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=hammer, args=(i % 2 == 0,))
               for i in range(SERVING["reload_threads"])]
    for t in threads:
        t.start()
    mgr.save(2, {"particles": gens[1]})
    start.wait(timeout=60)
    t0 = time.perf_counter()
    swapped = reloader.poll_once()
    reload_s = time.perf_counter() - t0
    swapped_event.set()
    for t in threads:
        t.join()
    bat.close()
    devs = [min(float(np.max(np.abs(r - w))) for w in want) for r in results]
    after = eng.predict(x)["mean"]
    per_gen = [sum(1 for r in results if np.array_equal(r, w)) for w in want]
    after_dev = float(np.max(np.abs(after - want[1])))
    row = {"phase": "serve_hot_reload", "n": n, "d": 1 + f, "threads": len(threads),
           "predicts": len(results), "errors": errors[:5], "swapped_step": swapped,
           "reload_wall_s": reload_s, "answers_by_generation_bitwise": per_gen,
           "max_abs_dev_from_a_generation": max(devs) if devs else None,
           "after_vs_new_max_abs_dev": after_dev, "generation_id": eng.stats()["generation_id"],
           "tolerance": SERVED_TOL, "card": card}
    ok = (not errors and swapped == 2 and len(results) >= len(threads) * SERVING["reload_calls"]
          and max(devs) <= SERVED_TOL and after_dev <= SERVED_TOL
          and eng.stats()["generation_id"] == 2)
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"serve_hot_reload: {row}")


def serving_phases(card):
    """Section 19, posterior-predictive serving (the constants above
    SERVING): serve_covertype, serve_bench, serve_buckets,
    profiler_overhead and serve_hot_reload.  Each prints its rows and raises
    when it fails; returns serve_bench's rows' requests a second, by
    variant."""
    import os
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_serving")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    serve_covertype_phase(root, card)
    serving_rps = serve_bench_phase(card)
    serve_buckets_phase(card)
    profiler_overhead_phase(card)
    serve_hot_reload_phase(root, card)
    return serving_rps


def rollout_drill_phase(card, serving_rps):
    """tools/rollout_drill.py at the serving width and its default
    durations (the constants above ROLLOUT_DRILL): every row_ok gate held,
    each pair's shadow p99 ratio (JAX's per-pair overhead, floored at 0,
    plus 1) and the spread between pairs printed, and beside the gate's
    share at the drill's rate the share a mirror on a busy dispatch thread
    would take at each of serve_bench's rates of this run
    (``serving_rps``)."""
    from dist_svgd_torch.tools import rollout_drill

    t0 = time.perf_counter()
    row = rollout_drill.run_drill(n_particles=SERVING["n"], dim=SERVING["features"],
                                  rows=ROLLOUT_DRILL["rows"],
                                  overhead_pairs=ROLLOUT_DRILL["overhead_pairs"])
    wall = time.perf_counter() - t0
    ok, why = rollout_drill.row_ok(row)
    pairs = row["overhead_pairs"]
    ok = ok and row["platform"] == "gpu" and row["sentry_supported"]
    busy_share = {variant: 1e-6 * row["mirror_us_per_request_busy"] * rps
                  for variant, rps in serving_rps.items()}
    emit({"phase": "rollout_drill", **row, "pair_p99_ratios": [1.0 + o for o in pairs],
          "pair_spread": (max(pairs) - min(pairs)) if pairs else None,
          "serving_rps": serving_rps, "busy_mirror_share_at_serving_rps": busy_share,
          "phase_wall_s": wall, "why": why, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"rollout_drill: {why}")


def rollout_offer_phase(root, card):
    """Two generations of serve_covertype's training on the card, the newer
    one offered by a CheckpointHotReloader(rollout=...) and walked to
    promotion by replayed traffic; then the newer step saturated, offered
    and rolled back (the constants above ROLLOUT_DRILL)."""
    import os

    import numpy as np
    import torch

    from dist_svgd_torch.experiments import covertype
    from dist_svgd_torch.ops import cuda_svgd
    from dist_svgd_torch.parallel.plan import capture_sentry
    from dist_svgd_torch.resilience import BadGenerationAt
    from dist_svgd_torch.rollout import RolloutPlan, prediction_divergence
    from dist_svgd_torch.serving import CheckpointHotReloader, ModelRegistry, PredictiveEngine
    from dist_svgd_torch.telemetry import MetricsRegistry
    from dist_svgd_torch.tools.rollout_drill import _drive_until
    from dist_svgd_torch.tools.workload_replay import (
        TraceConfig,
        generate_trace,
        make_submit,
        replay,
        window_metrics,
    )
    from dist_svgd_torch.utils.datasets import load_covertype

    reset, read = _serving_counts()
    ckpt = os.path.join(root, "rollout-ckpt")
    train = {k: v for k, v in ROLLOUT_TRAIN.items() if k != "niter"}
    niter = ROLLOUT_TRAIN["niter"]
    reset()
    t0 = time.perf_counter()
    parts1, gen1 = covertype.run(niter=niter, checkpoint_every=niter, checkpoint_dir=ckpt,
                                 **train)
    train1_s = time.perf_counter() - t0

    rows, tenant = ROLLOUT_TRAFFIC["rows"], "covertype"
    x, _ = load_covertype(ROLLOUT_TRAIN["nrows"], seed=ROLLOUT_TRAIN["seed"])
    held = x[-max(ROLLOUT_TRAIN["nrows"] // 10, 1):].astype(np.float32)
    pools = {rows: [held[i:i + rows] for i in range(0, len(held) - rows + 1, rows)]}
    metrics = MetricsRegistry()
    reg = ModelRegistry(metrics=metrics, max_batch=rows, lanes=1, max_wait_ms=2.0,
                        max_queue_rows=4096)
    reg.add_tenant(tenant, "logreg", checkpoint=ckpt, min_bucket=rows, max_bucket=rows)
    reg.warm()
    eng = reg.tenant(tenant).engine
    plan = RolloutPlan(**ROLLOUT_PLAN)
    ro = reg.begin_rollout(tenant, plan=plan)
    reloader = CheckpointHotReloader(eng, ckpt, rollout=ro)
    baseline = reloader.loaded_step

    t0 = time.perf_counter()
    parts2, gen2 = covertype.run(niter=2 * niter, checkpoint_every=niter, checkpoint_dir=ckpt,
                                 resume=True, **train)
    train2_s = time.perf_counter() - t0
    launched = read()

    t_offer = time.perf_counter()
    offered = reloader.poll_once()
    offer_s = time.perf_counter() - t_offer
    cfg = TraceConfig(duration_s=ROLLOUT_TRAFFIC["duration_s"],
                      base_rps=ROLLOUT_TRAFFIC["base_rps"], seed=ROLLOUT_SEED,
                      diurnal_amp=0.0, rows_sizes=(rows,), rows_alpha=0.0, tenants=(tenant,))
    submit = make_submit(reg.batcher, pools, model_registry=reg)
    with capture_sentry("rollout_offer window") as sentry:
        ro.start(ROLLOUT_TRAFFIC["control_interval_s"])
        records = replay(generate_trace(cfg), submit)
        tail, met = _drive_until(reg, tenant, pools[rows], lambda: not ro.active,
                                 timeout_s=ROLLOUT_TRAFFIC["timeout_s"])
        ro.stop()
    promote_wall = time.perf_counter() - t_offer
    st = ro.status()
    log = list(ro.log)
    promote = next((r for r in log if r["event"] == "promote"), None)
    whole = window_metrics(records + tail, 0.0, cfg.duration_s, plan.p99_ms)
    probe = pools[rows][0]
    served = {k: np.array(v, copy=True) for k, v in eng.predict(probe).items()}
    direct = PredictiveEngine("logreg", parts2, min_bucket=rows, max_bucket=rows).predict(probe)
    served_dev = max(float(np.max(np.abs(served[k] - direct[k]))) for k in direct)
    stats = eng.stats()

    # a bad candidate (the newer step saturated) under the same plan: rolled
    # back without a checkpoint read, the incumbent's bucket graph bitwise
    reloads = []
    eng.reload = lambda *a, **kw: reloads.append(1)
    t_bad = time.perf_counter()
    ro.offer(BadGenerationAt(0, kind="saturate").apply(parts2), tag="bad")
    ro.start(ROLLOUT_TRAFFIC["control_interval_s"])
    tail_bad, met_bad = _drive_until(reg, tenant, pools[rows], lambda: not ro.active,
                                     timeout_s=ROLLOUT_TRAFFIC["timeout_s"])
    ro.stop()
    rollback_wall = time.perf_counter() - t_bad
    del eng.reload
    after = eng.predict(probe)
    bitwise = all(np.array_equal(served[k], after[k]) for k in served)
    log_bad = list(ro.log)
    bad_offer = next((r for r in log_bad if r["event"] == "offer" and r["tag"] == "bad"), None)
    rollback = next((r for r in log_bad if r["event"] == "rollback"), None)
    bad_status = ro.status()
    reg.close()

    # both sides of the plan's divergence line: each request of the pool
    # through the incumbent (step 100), the promoted step and the saturated
    # one, on the card; every divergence of the good step at most
    # 1 / DIVERGENCE_MARGIN of the line, every one of the bad step at least
    # DIVERGENCE_MARGIN times it
    incumbent = PredictiveEngine("logreg", parts1, min_bucket=rows, max_bucket=rows)
    divs = {}
    for name, cand in (("good", parts2), ("saturated", BadGenerationAt(0, kind="saturate")
                                                       .apply(parts2))):
        ce = PredictiveEngine("logreg", cand, min_bucket=rows, max_bucket=rows)
        d = np.array([prediction_divergence(ce.predict(q), incumbent.predict(q))
                      for q in pools[rows]])
        divs[name] = {"min": float(d.min()), "median": float(np.median(d)),
                      "p99": float(np.percentile(d, 99)), "max": float(d.max()),
                      "requests": int(d.size)}
    line = plan.max_divergence
    divergence_held = (divs["good"]["max"] * DIVERGENCE_MARGIN <= line
                       and divs["saturated"]["min"] >= DIVERGENCE_MARGIN * line)

    # the training's φ lane, one call against the plain version
    S, k, m, d = SERVING_LANES[0][1]
    y, xs, sc = phi_inputs(S, k, m, d, ROLLOUT_SEED)
    got = cuda_svgd.phi_big_d_bf16x3_cuda(y, xs, sc, 1.0)
    torch.cuda.synchronize()
    want = cuda_svgd.phi_big_d_bf16x3_plain(y, xs, sc, 1.0)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    b_ms, b_by = bound_ms(*phi_work("phi_big_d_bf16x3", S, k, m, d, xs.numel()))
    lane = {"shape": [S, k, m, d], "bandwidth": 1.0, "max_abs_err": err,
            "max_abs_plain": scale, "tolerance": KERNEL_RTOL * scale,
            "ms": cuda_ms(lambda: cuda_svgd.phi_big_d_bf16x3_cuda(y, xs, sc, 1.0),
                          TIMED_LAUNCHES),
            "plain_ms": cuda_ms(lambda: cuda_svgd.phi_big_d_bf16x3_plain(y, xs, sc, 1.0),
                                OTHER_LAUNCHES),
            "bound_us": 1e3 * b_ms, "bound_by": b_by}
    del got, want, y, xs, sc
    others = {name: n for name, n in launched.items() if name != "phi_big_d_bf16x3"}
    row = {"phase": "rollout_offer", "train": ROLLOUT_TRAIN, "plan": plan.describe(),
           "traffic": ROLLOUT_TRAFFIC,
           "generations": [{k: g[k] for k in ("phi_impl", "niter", "resumed_from", "test_acc",
                                              "wall_s")} for g in (gen1, gen2)],
           "train_s": [train1_s, train2_s], "baseline_step": baseline, "offered_step": offered,
           "offer_s": offer_s, "offer_to_promote_s": promote_wall,
           "promote_s": (promote or {}).get("promote_s"),
           "stages": [r["fraction"] for r in log if r["event"] == "advance"],
           "promotions": st["promotions"], "rollbacks": st["rollbacks"],
           "serving_generation": stats["generation_id"], "ensemble_tag": stats["ensemble_tag"],
           "served_vs_newer_step_max_abs_dev": served_dev, "tolerance": SERVED_TOL,
           "traffic_met_promotion": met, "client": {k: whole[k] for k in (
               "offered", "completed", "shed", "errors", "lost", "p50_ms", "p99_ms")},
           "mirrors": int(metrics.counter("svgd_rollout_mirrors_total").value(tenant=tenant)),
           "sentry_compiles": sentry.compiles,
           "bad": {"rolled_back": rollback is not None, "at_stage": (rollback or {}).get("at_stage"),
                   "objectives": (rollback or {}).get("objectives"),
                   "offer_to_rollback_s": rollback_wall,
                   "controller_rollback_s": (rollback["t"] - bad_offer["t"]
                                             if rollback and bad_offer else None),
                   "requests": len(tail_bad), "checkpoint_reloads": len(reloads),
                   "incumbent_bitwise": bitwise,
                   "serving_generation": bad_status["serving_generation"]},
           "divergence": {"line": line, "margin": DIVERGENCE_MARGIN, **divs,
                          "held": divergence_held},
           "launches": launched, "lane": lane, "card": card}
    ok = (gen1["phi_impl"] == gen2["phi_impl"] == "cuda_bf16" and gen2["resumed_from"] == niter
          and baseline == niter and offered == 2 * niter and promote is not None
          and st["promotions"] == 1 and st["rollbacks"] == 0
          and row["stages"] == list(plan.canary_stages) and stats["ensemble_tag"] == f"step_{offered}"
          and served_dev <= SERVED_TOL and whole["lost"] == whole["errors"] == 0
          and sentry.compiles == 0 and launched["phi_big_d_bf16x3"] >= 2 * niter
          and met_bad and rollback is not None and not reloads and bitwise
          and bad_status["serving_generation"] == stats["generation_id"]
          and divergence_held
          and not any(others.values()) and err <= KERNEL_RTOL * scale
          and bool(np.isfinite(scale)))
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"rollout_offer: {row}")
    return launched


def cost_drill_phase(root, card):
    """tools/cost_drill.py at its defaults (the card's tenants), every
    row_ok gate held; its history ring through trace_report --programs and
    the anomaly report (the constants above ROLLOUT_DRILL say why)."""
    import contextlib
    import io
    import os

    from dist_svgd_torch.tools import anomaly_report, cost_drill, trace_report

    ring = os.path.join(root, "cost-ring")
    t0 = time.perf_counter()
    row = cost_drill.run_drill(history_dir=ring)
    wall = time.perf_counter() - t0
    _, why = cost_drill.row_ok(row)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trace_report.main(["--programs", ring, "--json", "--top", "1000"])
        anomaly_rc = anomaly_report.main([ring, "--rate", "--min-segment", "2", "--json"])
    summed, anomalies = (json.loads(line) for line in out.getvalue().strip().splitlines())
    final = trace_report.program_rows([cost_drill._LAST_REGISTRY[0].dump()])
    counts = [(p["label"], p["dispatches"], p["rows"], p["bytes"]) for p in summed["programs"]]
    want = [(p["label"], p["dispatches"], p["rows"], p["bytes"]) for p in final["programs"]]
    seconds_dev = abs(summed["total_seconds"] - final["total_seconds"])
    sums_equal = (counts == want and len(counts) > 0
                  and seconds_dev <= HISTORY_SUM_RTOL * final["total_seconds"])
    ok = (not why and rc == 0 and sums_equal and anomaly_rc in (0, 1)
          and row["platform"] == "gpu" and row["history_records"] == summed["windows"])
    emit({"phase": "cost_drill", **row, "tenant_particles": dict(cost_drill.CARD_TENANTS),
          "why": why, "trace_report_rc": rc, "ring_programs": counts,
          "ring_total_seconds": summed["total_seconds"],
          "dump_total_seconds": final["total_seconds"], "seconds_dev": seconds_dev,
          "anomaly_report_rc": anomaly_rc, "anomalies": anomalies["anomalies"][:5],
          "phase_wall_s": wall, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"cost_drill: {why}, trace_report rc {rc}, sums {counts} vs {want}")


def rollout_phases(card, serving_rps):
    """Section 20, progressive delivery and telemetry history (the constants
    above ROLLOUT_DRILL): rollout_drill, rollout_offer and cost_drill.  Each
    prints its row and raises when it fails; returns rollout_offer's launch
    counts.  ``serving_rps`` is section 19's serve_bench rates."""
    import os
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_rollout")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    rollout_drill_phase(card, serving_rps)
    launched = rollout_offer_phase(root, card)
    cost_drill_phase(root, card)
    emit({"phase": "rollout_section", "seconds": time.perf_counter() - t0})
    return launched


def supervised_phases(init, data, card, ct_ms_per_step):
    """Section 18, the supervised runs (the constants above RESHARD_LANES):
    supervised_covertype, supervised_covertype_sigterm, supervised_guards,
    elastic_reshard and fault_drill.  Each phase's launch counts are set to
    0 just before it and read just after; each prints one row and raises
    when it fails.  ``ct_ms_per_step`` is the unsupervised Covertype
    phase's exact-tier ms/step, printed beside the supervised one."""
    import os
    import shutil
    import signal

    import torch

    from dist_svgd_torch import DistSampler, telemetry
    from dist_svgd_torch.experiments import resilient_covertype as rcov
    from dist_svgd_torch.models.logreg import logreg_logp
    from dist_svgd_torch.ops import cuda_ot, cuda_svgd
    from dist_svgd_torch.resilience import (
        DeviceLossAt,
        FaultPlan,
        GuardConfig,
        InjectNaNAt,
        MeshGrowAt,
        MeshShrinkAt,
        RaiseAt,
        ReshardPolicy,
        RestartBudgetExhausted,
        RetryPolicy,
        RunSupervisor,
        TransientDispatchError,
    )
    from dist_svgd_torch.tools import fault_drill
    from dist_svgd_torch.utils import checkpoint as ckpt
    from dist_svgd_torch.utils.platform import resolve_device

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_supervised")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def reset_counts():
        torch.cuda.synchronize()
        cuda_svgd.reset_launch_counts()
        cuda_ot.reset_launch_counts()

    def counts():
        torch.cuda.synchronize()
        return {**cuda_svgd.launch_counts, **cuda_ot.launch_counts}

    def only(**launched):
        """Every kernel's expected count: ``launched``, 0 for the others."""
        return {**phi_counts(**launched),
                **{name: launched.get(name, 0) for name in cuda_ot.launch_counts}}

    def no_sleep(_s):
        pass

    # ---- supervised_covertype: kill at kill_step, resume, bitwise ----------
    # warmed first (untimed steps of the same sampler), so the reference's
    # ms/step is a steady one, as the unsupervised covertype rows' are; the
    # save's parts are timed on its state: the host copy, the npz write and
    # rename, and the retention's delete of an old step
    sc = SUPERVISED_CT
    make, _, n_used = rcov.build(nrows=sc["nrows"], nproc=sc["nproc"],
                                 nparticles=sc["nparticles"], batch_size=sc["batch_size"])
    warm = make()
    warm.run_steps(COVERTYPE["warm_steps"], COVERTYPE["step_size"])
    parts_ms = {"state_dict": [], "save_state": [], "delete_step": []}
    for rep in range(CKPT_PARTS_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = warm.state_dict()
        parts_ms["state_dict"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        path = ckpt.save_state(os.path.join(root, "ckpt_parts", f"step_{rep}"), state)
        parts_ms["save_state"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        shutil.rmtree(path)
        parts_ms["delete_step"].append(1e3 * (time.perf_counter() - t0))
    del warm
    reset_counts()
    t0 = time.perf_counter()
    out, reports = rcov.run(root=os.path.join(root, "covertype"), **sc)
    wall = time.perf_counter() - t0
    launched = counts()
    ref = reports["reference"]
    expect = sc["niter"] + sc["kill_step"] + (sc["niter"] - sc["kill_step"])
    npz = os.path.join(root, "covertype", "reference", f"step_{sc['niter']}", "state.npz")
    row = {"phase": "supervised_covertype", **{k: v for k, v in out.items() if k != "root"},
           "launches": launched, "phase_wall_s": wall,
           "supervised_ms_per_step": 1e3 * ref["wall_s"] / ref["steps_run"],
           "supervised_segment_ms_per_step": 1e3 * ref["segment_wall_s"] / ref["steps_run"],
           "unsupervised_ms_per_step": ct_ms_per_step,
           "checkpoint_save_ms": 1e3 * ref["checkpoint_wall_s"] / ref["checkpoints"],
           "checkpoint_bytes": os.path.getsize(npz),
           "checkpoint_overhead_frac": ref["checkpoint_overhead_frac"],
           "checkpoint_parts_ms": parts_ms,
           "resume_ms_per_step": 1e3 * reports["resume"]["wall_s"]
           / reports["resume"]["steps_run"], "card": card}
    ok = (out["kill"] == {"status": "preempted", "t": sc["kill_step"]}
          and out["resume"]["resumed_from"] == sc["kill_step"]
          and out["resume"]["bitwise_identical"]
          and out["resume"]["max_abs_dev_vs_uninterrupted"] == 0.0
          and out["serve"]["hot_reload_step"] == sc["niter"]
          and out["serve"]["cold_start_particles"] == n_used
          and out["serve"]["served_vs_direct_max_abs_dev"] <= SERVED_TOL
          and launched == only(phi_big_d=expect))
    emit({**row, "expected_phi_big_d": expect, "ok": ok})
    if not ok:
        raise AssertionError(f"supervised_covertype: {row}")

    # ---- supervised_covertype_sigterm: a real SIGTERM to a subprocess -------
    sroot = os.path.join(root, "sigterm")
    args = ["--nrows", sc["nrows"], "--nproc", sc["nproc"], "--nparticles", sc["nparticles"],
            "--batch-size", sc["batch_size"], "--niter", SIGTERM_RUN["niter"],
            "--checkpoint-every", sc["checkpoint_every"], "--segment-steps",
            sc["segment_steps"], "--real-signals", "--root", sroot]
    env = dict(os.environ)
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    marker = os.path.join(sroot, "killed", f"step_{SIGTERM_RUN['wait_step']}")
    os.makedirs(sroot)
    t0 = time.perf_counter()
    with open(os.path.join(sroot, "stdout"), "w") as fo, \
            open(os.path.join(sroot, "stderr"), "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dist_svgd_torch.experiments.resilient_covertype",
             *map(str, args)], cwd=here, env=env, stdout=fo, stderr=fe)
        try:
            deadline = time.monotonic() + SIGTERM_RUN["timeout_s"]
            while not os.path.isdir(marker):
                if proc.poll() is not None:
                    raise AssertionError(f"sigterm run exited {proc.returncode} before "
                                         f"{marker} existed")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"sigterm run: no {marker} within "
                                       f"{SIGTERM_RUN['timeout_s']} s")
                time.sleep(0.002)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=SIGTERM_RUN["timeout_s"])
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    lines = open(os.path.join(sroot, "stdout")).read().strip().splitlines()
    sout = json.loads(lines[-1]) if rc == 0 and lines else {}
    kill = sout.get("kill", {})
    row = {"phase": "supervised_covertype_sigterm", "returncode": rc,
           "wall_s": time.perf_counter() - t0, "niter": SIGTERM_RUN["niter"],
           "signal_after_step": SIGTERM_RUN["wait_step"], "reference": sout.get("reference"),
           "kill": kill, "resume": sout.get("resume"),
           "stderr_tail": open(os.path.join(sroot, "stderr")).read()[-600:] if rc else ""}
    ok = (rc == 0 and kill.get("status") == "preempted"
          and SIGTERM_RUN["wait_step"] <= kill.get("t", -1) < SIGTERM_RUN["niter"]
          and sout["resume"]["resumed_from"] == kill["t"]
          and sout["resume"]["bitwise_identical"])
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"supervised_covertype_sigterm: {row}")

    # ---- supervised_guards: NaN rollback, retry, exhausted budget ----------
    g = GUARDS
    reg = telemetry.MetricsRegistry()
    pm_dir = os.path.join(root, "postmortem")
    rec = telemetry.FlightRecorder(capacity=4096, dump_dir=pm_dir, registry=reg)
    step_size = 1e-4

    def guarded(name, **kw):
        diag = telemetry.PosteriorDiagnostics(
            telemetry.DiagnosticsConfig(every_steps=g["diag_every"]), registry=reg)
        kw.setdefault("sleep", no_sleep)
        return RunSupervisor(make(), g["steps"], step_size,
                             checkpoint_dir=os.path.join(root, name),
                             checkpoint_every=g["checkpoint_every"],
                             segment_steps=g["segment_steps"], registry=reg, recorder=rec,
                             diagnostics=diag,
                             guard=GuardConfig(min_ess_frac=g["min_ess_frac"]), **kw)

    reset_counts()
    ref_sup = guarded("guard_ref")
    r_ref = ref_sup.run()
    nan_sup = guarded("guard_nan", faults=FaultPlan(InjectNaNAt(g["fault_step"])))
    r_nan = nan_sup.run()
    slept = []
    raise_sup = guarded("guard_raise", faults=FaultPlan(RaiseAt(g["fault_step"])),
                        sleep=slept.append,
                        retry=RetryPolicy(max_restarts=3, backoff_base_s=g["backoff_base_s"]))
    r_raise = raise_sup.run()
    budget_sup = guarded("guard_budget", faults=FaultPlan(RaiseAt(g["fault_step"])),
                         retry=RetryPolicy(max_restarts=0))
    try:
        budget_sup.run()
        exhausted = None
    except RestartBudgetExhausted as e:
        exhausted = e
    launched = counts()
    bundles = sorted(os.listdir(pm_dir))
    readback = {}
    for name in bundles:
        tool = subprocess.run(
            [sys.executable, "-m", "dist_svgd_torch.tools.trace_report",
             os.path.join(pm_dir, name), "--postmortem"], cwd=here, env=env,
            capture_output=True, text=True, timeout=300)
        readback[name] = {"returncode": tool.returncode,
                          "first_line": tool.stdout.splitlines()[0] if tool.stdout else "",
                          "guard_reason": "context.guard_reason = non-finite particle state"
                          in tool.stdout}
    # segments the grid predicts: 40 clean; NaN at 10 → trip at 20, back to
    # 0, 40 more; raise at 10 → back to 0, 40 more; budget 0 → 10
    expect = g["steps"] + (2 * g["fault_step"] + g["steps"]) + (g["fault_step"] + g["steps"]) \
        + g["fault_step"]
    ess_frac = (r_ref["last_diagnostics"] or {}).get("ess_frac")
    row = {"phase": "supervised_guards", "n": n_used, "steps": g["steps"],
           "reference": {k: r_ref[k] for k in ("status", "restarts", "step_size")},
           "nan": {k: r_nan[k] for k in ("status", "restarts", "step_size")},
           "raise": {k: r_raise[k] for k in ("status", "restarts")}, "slept": slept,
           "raise_bitwise_reference": bool(torch.equal(raise_sup.particles,
                                                       ref_sup.particles)),
           "budget_exhausted": exhausted is not None,
           "budget_last_error": type(exhausted.last_error).__name__ if exhausted else None,
           "ess_frac": ess_frac, "min_ess_frac": g["min_ess_frac"],
           "diagnostics": reg.counter("svgd_diag_computations_total").value(),
           "bundles": bundles, "readback": readback, "launches": launched,
           "expected_phi_big_d": expect, "card": card}
    ok = (r_ref["status"] == "completed" and r_ref["restarts"] == 0
          and r_nan["status"] == "completed" and r_nan["restarts"] == 1
          and r_nan["step_size"] == step_size * GuardConfig().backoff_factor
          and bool(torch.isfinite(nan_sup.particles).all())
          and r_raise["status"] == "completed" and r_raise["restarts"] == 1
          and slept == [g["backoff_base_s"]] and row["raise_bitwise_reference"]
          and exhausted is not None
          and isinstance(exhausted.last_error, TransientDispatchError)
          and ess_frac is not None and ess_frac > g["min_ess_frac"]
          and bundles == ["postmortem_001_guard_violation.jsonl",
                          "postmortem_002_restart_budget_exhausted.jsonl"]
          and all(r["returncode"] == 0 for r in readback.values())
          and readback[bundles[0]]["guard_reason"]
          and launched == only(phi_big_d=expect))
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"supervised_guards: {row}")
    del ref_sup, nan_sup, raise_sup, budget_sup

    # ---- elastic_reshard: the north star under shrink, grow, device loss ---
    # Every shard scores against the whole training set (the logp closes over
    # it): passed as data=, the rows would be split S ways, and a trajectory
    # whose per-shard data change with S is not the never-resharded one.
    e = ELASTIC
    ns = NORTH_STAR
    x_full, t_full = (a.to(resolve_device(None)) for a in data)

    def logp_full(theta, _=None):
        return logreg_logp(theta, (x_full, t_full))

    def factory(num_shards):
        return DistSampler(num_shards, logp_full, None, init, exchange_particles=True,
                           exchange_scores=False, include_wasserstein=False)

    def elastic(name, **kw):
        return RunSupervisor(factory(ns["shards"]), e["steps"], ns["step_size"],
                             checkpoint_dir=os.path.join(root, name),
                             checkpoint_every=e["checkpoint_every"],
                             segment_steps=e["segment_steps"], sleep=no_sleep, **kw)

    base = elastic("elastic_base")
    base.run()
    reg = telemetry.MetricsRegistry()
    tracer = telemetry.enable()
    reset_counts()
    t0 = time.perf_counter()
    try:
        el = elastic("elastic", registry=reg, reshard=ReshardPolicy(factory),
                     faults=FaultPlan(MeshShrinkAt(*e["shrink"]), MeshGrowAt(*e["grow"]),
                                      DeviceLossAt(e["loss"][0], lost=e["loss"][1])))
        r_el = el.run()
    finally:
        telemetry.disable()
    wall = time.perf_counter() - t0
    launched = counts()
    traced = tracer.counts()
    dev = float((el.particles - base.particles).abs().max())
    rel = dev / float(base.particles.abs().max())
    events = [{k: v for k, v in ev.items() if k not in ("reshard_wall_s", "recovery_wall_s")}
              for ev in r_el["reshard_events"]]
    seg = e["segment_steps"]
    ckpt = e["checkpoint_every"]
    want_events = []
    shards = ns["shards"]
    for t_fault, to, requested in ((e["shrink"][0], e["shrink"][1], e["shrink"][1]),
                                   (e["grow"][0], e["grow"][1], e["grow"][1]),
                                   (e["loss"][0], 5, 5)):
        t_det = -(-t_fault // seg) * seg
        want_events.append({"t_detected": t_det, "resumed_from": t_det // ckpt * ckpt,
                            "from_shards": shards, "requested_shards": requested,
                            "to_shards": to, "from_processes": 1, "to_processes": 1,
                            "steps_lost": t_det - t_det // ckpt * ckpt})
        shards = to
    lost = sum(ev["steps_lost"] for ev in want_events)
    row = {"phase": "elastic_reshard", "n": ns["n"], "steps": e["steps"],
           "events": events, "expected_events": want_events,
           "reshard_wall_s": [ev["reshard_wall_s"] for ev in r_el["reshard_events"]],
           "recovery_wall_s": [ev["recovery_wall_s"] for ev in r_el["reshard_events"]],
           "num_shards": r_el["num_shards"], "restarts": r_el["restarts"],
           "max_abs_dev_vs_never_resharded": dev, "rel_dev": rel, "bound": TRAJ_RTOL,
           "reshards_total": {d: reg.counter("svgd_elastic_reshards_total").value(direction=d)
                              for d in ("shrink", "grow")},
           "steps_lost_total": reg.counter("svgd_elastic_steps_lost_total").value(),
           "train_reshard_spans": traced.get("train.reshard", 0),
           "kernel_builds": traced.get("kernel_build", 0), "wall_s": wall,
           "launches": launched, "card": card}
    ok = (r_el["status"] == "completed" and events == want_events
          and r_el["num_shards"] == 5 and rel <= TRAJ_RTOL
          and row["reshards_total"] == {"shrink": 2, "grow": 1}
          and row["steps_lost_total"] == lost and row["train_reshard_spans"] == 3
          and row["kernel_builds"] == 0
          and launched == only(phi_small_d=e["steps"] + lost))
    emit({**row, "ok": ok})
    if not ok:
        raise AssertionError(f"elastic_reshard: {row}")
    del base, el

    # ---- fault_drill: the port's tool at its defaults -----------------------
    reset_counts()
    drill = fault_drill.run_drill(root=os.path.join(root, "drill"))
    launched = counts()
    ok = (drill["resumed_bitwise_identical"] and drill["retry_backoff_recovered"]
          and drill["nan_rollback_recovered"] and launched["phi_small_d"] > 0
          and launched == only(phi_small_d=launched["phi_small_d"]))
    # overhead_under_5pct is recorded, not gated: a timing of a host-bound step
    emit({"phase": "fault_drill", **drill, "launches": launched, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"fault_drill: {drill}")


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
    lane_rows()
    ring_ot_rows()
    reshard_lane_rows()
    serving_lane_rows()

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
    launches_ct, ct_ms_per_step = covertype_phases()
    covertype_nproc1_phase()

    # ---- 12. the BNN (BASELINE config 5, d = 753) through its driver -------
    launches_bnn, launches_bnn_bf16 = bnn_phases()

    # ---- 13. the autotune tool and the φ policy's gates ---------------------
    launches_tool = autotune_phase()
    auto_gates_phase()

    # ---- 14. the reference's entry points (BASELINE configs 1-2) -----------
    logreg_phases()
    gmm_phase()

    # ---- 15. resumable, budgeted runs --------------------------------------
    resumable_phases(data, init, x_test, t_test)

    # ---- 16. observability: the tracer and the posterior diagnostics ------
    telemetry_phase(init, data, card)
    diagnostics_phase(ds, data, card)

    # ---- 17. the sub-quadratic φ and its 'auto' crossover ------------------
    large_n_approx_phase(card)
    approx_crossover_phase(card)
    approx_north_star_phase(init, data, card)

    # ---- 18. supervised runs: preemption, guards, reshards, the drill ------
    supervised_phases(init, data, card, ct_ms_per_step["cuda"])

    # ---- 19. serving: engine, batcher, registry, server, profiler --------
    serving_rps = serving_phases(card)

    # ---- 20. progressive delivery and telemetry history ---------------------
    rollout_phases(card, serving_rps)

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
