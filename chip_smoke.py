#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dist_svgd_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written φ kernels from ``dist_svgd_torch/csrc/`` with
``nvcc``, holds each against its plain PyTorch version at the main path's
shapes and at a ragged shape, drives the north-star path (10,000-particle
Bayesian logistic regression, 8 emulated shards, ``all_particles``) through
``DistSampler.run_steps`` and checks that it went through the kernels, and
prints one JSON object per phase.  A phase that fails raises, so the script
exits non-zero; the last line, printed only when every phase passed, is

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

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit):
# float32 outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Kernel parity tolerance: max|Δ| ≤ KERNEL_RTOL · max|φ_plain|.  Both sides
# are float32; they sum the m = 10,000 pair terms in different orders (the
# kernel in chunked sequential FMA chains plus a fixed-order split reduction,
# the plain version through cuBLAS), and the big-d distance form cancels in
# y² + x² − 2·y·x, so ~1e-6 relative is expected; 1e-4 leaves room without
# hiding a wrong index.
KERNEL_RTOL = 1e-4
# Trajectory tolerance: max|θ_cuda − θ_torch| ≤ TRAJ_RTOL · max|θ| after 20
# steps from the same init.  Per-step φ agreement is ~1e-6 of max|φ|, scaled
# by the step size, so the two float32 trajectories agree far below this.
TRAJ_RTOL = 1e-4
# Small-input reference: the port on the card (float32, phi_impl='cuda')
# against the port on the CPU (float64, phi_impl='torch'), 3 steps, all
# three exchange modes — float32 rounding of O(1) particles.
SMALL_RTOL = 1e-5

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
}


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def bound_ms(name, S, k, m, d, x_numel):
    """Least time the card could take for one call: the larger of the bytes
    it must move (y, x, s read once, φ written once; float32) over HBM
    bandwidth and its float32 operations over the float32 peak."""
    nbytes = 4 * (S * k * d + x_numel + S * m * d + S * k * d)
    flops = S * k * m * KERNELS[name]["flops_per_pair"](d)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


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


def profile_steps(ds, step_size, steps=PROFILE_STEPS):
    """Device time by kernel over ``steps`` sampler steps, from the CUDA
    activities of a torch.profiler trace, and the device's busy share of the
    host wall time of those steps (one stream, so kernels do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ds.run_steps(steps, step_size)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, count = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), count + 1)
    device_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"phase": "profile", "steps": steps,
            "wall_ms_per_step": wall_us / 1e3 / steps,
            "device_ms_per_step": device_us / 1e3 / steps if device_us else "not measured",
            "device_busy_share": device_us / wall_us if device_us else "not measured",
            "device_ops_per_step": sum(c for _, c in by_name.values()) / steps,
            "top_kernels_ms_per_step": {name[:80]: us / 1e3 / steps
                                        for name, (us, _) in top}}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1

    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.models.logreg import ensemble_test_accuracy, logreg_logp
    from dist_svgd_torch.ops import _build, cuda_svgd
    from dist_svgd_torch.utils.datasets import load_benchmark
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
    kernel_fns = {"phi_small_d": (cuda_svgd.phi_small_d_cuda, cuda_svgd.phi_small_d_plain),
                  "phi_big_d": (cuda_svgd.phi_big_d_cuda, cuda_svgd.phi_big_d_plain)}
    # (kernel, (S, k, m, d), bandwidth, shared x, role).  The main shapes are
    # the north star's: 8 lanes × 1250 rows against 10,000 particles, at
    # banana's d=3 and splice's d=61.  Big-d checks use h = 2d so the Gram
    # stays O(1) and the check exercises exp and drive (at h=1 and d=61
    # nearly every off-diagonal K underflows to 0).
    cases = [
        ("phi_small_d", (8, 1250, 10_000, 3), 1.0, True, "main"),
        ("phi_small_d", (3, 1000, 777, 5), 1.0, True, "ragged"),
        ("phi_small_d", (8, 1250, 1250, 3), 1.0, False, "partitions"),
        ("phi_big_d", (8, 1250, 10_000, 61), 122.0, True, "main"),
        ("phi_big_d", (1, 300, 517, 9), 18.0, True, "ragged"),
        ("phi_big_d", (2, 200, 333, 128), 256.0, False, "widest"),
    ]
    timing = {}
    for seed, (name, (S, k, m, d), h, shared, role) in enumerate(cases):
        kern, plain = kernel_fns[name]
        y, x, s = phi_inputs(S, k, m, d, seed, shared)
        got = kern(y, x, s, h)
        torch.cuda.synchronize()
        want = plain(y, x, s, h)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
        row = {"phase": "kernel_parity", "kernel": name, "role": role,
               "shape": [S, k, m, d], "bandwidth": h, "max_abs_err": err,
               "max_abs_plain": scale, "tolerance": KERNEL_RTOL * scale, "ok": ok}
        if role == "main":
            ms = cuda_ms(lambda: kern(y, x, s, h), TIMED_LAUNCHES)
            plain_ms = cuda_ms(lambda: plain(y, x, s, h), TIMED_LAUNCHES)
            b_ms, b_by = bound_ms(name, S, k, m, d, x.numel())
            timing[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by}
            row.update(ms=ms, plain_ms=plain_ms, bound_us=1e3 * b_ms, bound_by=b_by)
        emit(row)
        if not ok:
            raise AssertionError(f"{name} {role}: max|Δ| {err} > {KERNEL_RTOL} × {scale}")

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
    if not finite or launches_small != {"phi_small_d": ns["steps"], "phi_big_d": 0}:
        raise AssertionError(f"north star: finite={finite} launches={launches_small}")

    # ---- 4b. where a north-star step's time goes (torch.profiler) ---------
    emit(profile_steps(ds, ns["step_size"]))

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
    if not finite or launches_big != {"phi_small_d": 0, "phi_big_d": BIG_D_STEPS}:
        raise AssertionError(f"big-d path: finite={finite} launches={launches_big}")

    # ---- 7. small-input reference: card f32 vs CPU f64 --------------------
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

    launches = {"phi_small_d": launches_small["phi_small_d"],
                "phi_big_d": launches_big["phi_big_d"]}
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
