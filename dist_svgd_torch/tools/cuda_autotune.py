"""Autotune and roofline measurement for the port's φ kernels on the card —
the port of ``tools/pallas_autotune.py``.

    python -m dist_svgd_torch.tools.cuda_autotune [--iters 50] [--skip-sweep]
    python -m dist_svgd_torch.tools.cuda_autotune --big-d
    python -m dist_svgd_torch.tools.cuda_autotune --harvest

Every mode runs on the card and raises without CUDA; ``--device cpu`` runs
the same steps on the kernels' plain versions, timed by the host clock — a
rehearsal of the tool, not a measurement of anything on the card.

Default mode, at (k, m, d) = (:data:`K`, :data:`M`, :data:`D`):

1. **exp roofline**: a chained ``torch.exp(-c)`` on an :data:`EXP_N`² tile
   in f32 and bf16.  Each step is two elementwise kernels (``neg`` and
   ``exp``) over a tile larger than L2 (f32), so the loop is bound by memory,
   and its exp/s is printed beside its bytes/s: it is not the SFU's rate.
2. **split sweep**: the torch φ (JAX's "XLA fused" row), then the small-d
   kernel over :data:`SPLIT_LADDER`, the m-split's target of blocks per SM.
   The port's tiles are compile-time constants (``csrc/phi_small_d.cu``),
   so JAX's (block_k, block_m) grid has no counterpart; the split is the
   kernel's one run-time knob.
3. **no-exp ablation**: the exact kernel, the no-exp probe
   (``phi_small_d_noexp``, chained through ``clamp(·, -1, 1)`` as JAX's
   ``clip``) and the bf16 tier, timed as one interleaved group; the exp
   share ``(T_full − T_noexp)/T_full``; both tiers' ``max|φ − φ_f64| /
   max|φ|`` on 2000 rows against :func:`f64_oracle_phi`.  JAX's chain is
   one jitted scan; here every step is dispatched from Python, and at
   (10k, 10k, 3) that dispatch takes about as long as the kernel, so on
   the card the ablation also reads the φ kernels' own device time from
   ``torch.profiler`` (:func:`kernel_device_ms`) and the exp share from it.

``--big-d``: at (:data:`BIG_K`, :data:`BIG_M`, :data:`BIG_D`), h = 2d, the
exact kernel, the bf16x3 kernel and the torch φ, interleaved, and both
tiers' f64 budgets on 200 rows.  JAX's (256², 256×1024) tile A/B has no
counterpart, for the same reason as the sweep's grid.

``--harvest``: (a) the split ladder at each shape of :data:`HARVEST_SHAPES`
(JAX's five, the BNN lane and the 8-lane north-star lane), its winner beside
the kernel's own target (``cuda_svgd.blocks_per_sm``: the one its source
records) — the port's
reading of JAX's ``_MEASURED_BLOCKS``, printed and not applied; (b) for each
``'auto'`` gate, the kernel against the torch φ over the n² ladder :data:`GATE_RUNGS` at S = 1 and the dims of
:data:`GATE_DIMS`, ending with the two lines to paste into
``dist_svgd_torch/ops/cuda_svgd.py``.  A gate is the rung from which the
kernel is no slower (:func:`crossover`), and 0 — no gate — where the
kernel is no slower from the ladder's first rung, one pair; a run of
losses at the top rungs is printed as kernel work and draws no upper line,
as JAX has none.  For d > 8 the gate is the larger of the two dims' lines.

Each mode's function returns what it printed, as a dict; :func:`main`
returns the mode's dict (the smoke run reads it).
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.ops.svgd import phi
from dist_svgd_torch.utils.platform import resolve_device

K = M = 10_000
D = 3

# --big-d: the Covertype per-lane φ shape
BIG_K, BIG_M, BIG_D = 1250, 10_000, 55

#: The exp roofline's tile side.
EXP_N = 4096

#: The m-split targets of the sweep, in blocks per SM.
SPLIT_LADDER = (1, 2, 4, 8, 16, 32)

#: --harvest (a), (S, k, m, d): JAX's five shapes (one lane each), the BNN's
#: lane and the north-star's 8 lanes.
HARVEST_SHAPES = [
    (1, 1_250, 10_000, 3),      # 8-shard lane, north star
    (1, 10_000, 10_000, 3),     # unsharded 10k square
    (1, 12_500, 100_000, 3),    # 8-shard lane at n = 100k
    (1, 100_000, 100_000, 3),   # unsharded 100k square
    (1, 1_250, 10_000, 55),     # big-d Covertype lane
    (1, 500, 500, 753),         # the BNN's one lane
    (8, 1_250, 10_000, 3),      # the north star's 8 lanes in one launch
]

#: --harvest (b): the n of the n² ladder, from one pair up, and the dims
#: each gate is read at.
GATE_RUNGS = tuple(1 << i for i in range(13))
GATE_DIMS = {"CUDA_MIN_PAIRS": (3,), "CUDA_MIN_PAIRS_BIG_D": (55, 753)}

EPS = 1e-6

def _nsplit(name: str, S: int, k: int, m: int, device: torch.device,
            blocks_per_sm: int, d: Optional[int] = None) -> Optional[int]:
    """The m-split a launch takes on the card (``None`` on the CPU); a
    wide-d kernel's at feature dim ``d``."""
    if device.type != "cuda":
        return None
    return cuda_svgd.split_count(name, S, k, m, device, blocks_per_sm, d)


def _chain(fn: Callable, x0: torch.Tensor, iters: int) -> torch.Tensor:
    c = x0
    for _ in range(iters):
        c = fn(c)
    return c


def _seconds(run: Callable[[], torch.Tensor], device: torch.device) -> float:
    """Seconds of ``run()``: between two CUDA events fenced by their
    synchronize on the card, by the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, x0: torch.Tensor, iters: int, reps: int = 3) -> float:
    """Seconds per step of ``reps`` chains of ``iters`` steps ``c = fn(c)``
    after one untimed chain (which builds and loads the kernels)."""
    _chain(fn, x0, iters)
    _sync(x0.device)

    def run():
        out = x0
        for _ in range(reps):
            out = _chain(fn, out, iters)
        return out

    return _seconds(run, x0.device) / (reps * iters)


def timed_group(named_fns: Sequence[Tuple[str, Callable]], x0: torch.Tensor,
                iters: int, samples: int = 3) -> Dict[str, float]:
    """Interleaved min-of-samples seconds per step of several step
    functions: in each sample every function runs one untimed chain right
    before its timed one, so that no variant is timed from an idle card and
    drift over the run hits all variants alike (the JAX tool's protocol)."""
    for _, fn in named_fns:
        _chain(fn, x0, iters)  # build and load, untimed
    _sync(x0.device)
    best = {name: float("inf") for name, _ in named_fns}
    for _ in range(samples):
        for name, fn in named_fns:
            _chain(fn, x0, iters)
            _sync(x0.device)
            t = _seconds(lambda: _chain(fn, x0, iters), x0.device) / iters
            best[name] = min(best[name], t)
    return best


#: The CUDA kernels of one small-d φ call (every mode): the partial sums
#: and the split reduction.
PHI_KERNEL_NAMES = ("phi_small_d_partial", "phi_finalize")


def kernel_device_ms(fn: Callable, x0: torch.Tensor, iters: int,
                     names: Sequence[str]) -> float:
    """Device ms per step of the CUDA kernels whose names contain one of
    ``names``, summed over one chain of ``iters`` steps under
    ``torch.profiler`` (on the card only): the kernels' own durations,
    without the host's dispatch gaps between them."""
    from torch.profiler import ProfilerActivity, profile

    _chain(fn, x0, iters)
    _sync(x0.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _chain(fn, x0, iters)
        _sync(x0.device)
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and any(name in ev.name for name in names))
    return us / 1e3 / iters


def _step(fn: Callable) -> Callable:
    """The chained step ``c + eps·fn(c)``: φ's output fed back into y."""
    return lambda c: c + EPS * fn(c)


def _inputs(rng, S: int, k: int, m: int, d: int, device) -> Tuple[torch.Tensor, ...]:
    """f32 y ``(S, k, d)``, x ``(m, d)``, s ``(S, m, d)`` drawn as JAX's tool
    draws them (y, then x, then s, standard normal)."""
    y = rng.normal(size=(S, k, d)) if S > 1 else rng.normal(size=(k, d))[None]
    x = rng.normal(size=(m, d))
    s = rng.normal(size=(S, m, d)) if S > 1 else rng.normal(size=(m, d))[None]
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
                 for a in (y, x, s))


def f64_oracle_phi(y, x, s, h=1.0):
    """Loopless f64 numpy φ for error budgets (JAX's tool's, copied)."""
    y64, x64, s64 = (np.asarray(a, np.float64) for a in (y, x, s))
    d2 = ((y64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    kt = np.exp(-d2 / h)
    drive = kt @ s64
    repulse = (2.0 / h) * (y64 * kt.sum(1)[:, None] - kt @ x64)
    return (drive + repulse) / x64.shape[0]


def _f64_budget(name: str, y, x, s, h: float, rows: int) -> float:
    """``max|φ − φ_f64| / max|φ_f64|`` of kernel ``name`` on the first
    ``rows`` rows of lane 0."""
    ys = y[:1, :rows].contiguous()
    want = f64_oracle_phi(ys[0].cpu().numpy(), x.cpu().numpy(), s[0].cpu().numpy(), h)
    got = cuda_svgd.launch(name, ys, x, s[:1], h)[0].double().cpu().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rate(pairs: int, t: float) -> str:
    return f"{t * 1e3:8.4f} ms  ({pairs / t / 1e9:7.1f} G pairs/s)"


def exp_roofline(iters: int, device: torch.device) -> Dict[str, dict]:
    """exp/s and bytes/s of a chained ``torch.exp(-c)`` on an
    :data:`EXP_N`² tile, f32 and bf16."""
    n = EXP_N
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.ones((n, n), dtype=dtype, device=device)
        t = timed(lambda c: torch.exp(-c), x, iters)
        nbytes = 4 * n * n * x.element_size()  # neg and exp each read and write
        out[label] = {"ms": t * 1e3, "exp_per_s": n * n / t, "bytes_per_s": nbytes / t}
        print(f"exp roofline {label:4s}: {n * n / t / 1e9:8.2f} G exp/s  "
              f"{nbytes / t / 1e9:8.1f} GB/s  ({t * 1e3:.4f} ms / {n}x{n}; "
              "memory-bound, not the SFU's rate)", flush=True)
    return out


def sweep(y, x, s, iters: int) -> Dict:
    """The torch φ, then the small-d kernel over :data:`SPLIT_LADDER`."""
    S, k, _ = y.shape
    m = x.shape[0]
    pairs = S * k * m
    results = {}
    t = timed(_step(lambda c: phi(c, x, s, RBF(1.0))), y, iters)
    results["torch"] = t
    print(f"torch φ                           : {_rate(pairs, t)}", flush=True)
    for bps in SPLIT_LADDER:
        t = timed(_step(lambda c, b=bps: cuda_svgd.launch("phi_small_d", c, x, s, 1.0, b)),
                  y, iters)
        results[bps] = t
        ns = _nsplit("phi_small_d", S, k, m, y.device, bps)
        print(f"small-d kernel {bps:2d} blocks/SM (nsplit {ns}): {_rate(pairs, t)}",
              flush=True)
    return results


def default_mode(iters: int, skip_sweep: bool, device: torch.device) -> Dict:
    """The exp roofline, the sweep and the no-exp ablation at (K, M, D)."""
    rng = np.random.default_rng(0)
    y, x, s = _inputs(rng, 1, K, M, D, device)
    pairs = K * M
    out = {}
    if not skip_sweep:
        out["exp_roofline"] = exp_roofline(iters, device)
        results = sweep(y, x, s, iters)
        best = min(results, key=results.get)
        print(f"\nbest: {best}  {results[best] * 1e3:.4f} ms  "
              f"(torch/best ratio {results['torch'] / results[best]:.2f}x)")
        out["sweep_ms"] = {str(key): t * 1e3 for key, t in results.items()}

    programs = [
        ("full", _step(lambda c: cuda_svgd.launch("phi_small_d", c, x, s))),
        ("noexp", lambda c: c + EPS * torch.clamp(
            cuda_svgd.launch("phi_small_d_noexp", c, x, s), -1.0, 1.0)),
        ("bf16", _step(lambda c: cuda_svgd.launch("phi_small_d_bf16", c, x, s))),
    ]
    best = timed_group(programs, y, iters)
    t_full, t_noexp, t_bf16 = best["full"], best["noexp"], best["bf16"]
    share = (t_full - t_noexp) / t_full
    print()
    print(f"φ full f32  : {_rate(pairs, t_full)}")
    print(f"φ no-exp    : {_rate(pairs, t_noexp)}  → exp share ≈ {share * 100:.1f}% of the call")
    print(f"φ bf16-exp  : {_rate(pairs, t_bf16)}  ({t_full / t_bf16:.2f}x vs f32)")
    if device.type == "cuda":
        # the chained steps above include the host's dispatch of each step,
        # which at 1e8 pairs is as long as the kernel; the profiler's
        # kernel durations leave it out
        dev = {name: kernel_device_ms(fn, y, iters, PHI_KERNEL_NAMES) for name, fn in programs}
        out["device_ms"] = dev
        out["exp_share_device"] = (dev["full"] - dev["noexp"]) / dev["full"]
        print(f"device time of the φ kernels (torch.profiler): full {dev['full']:.4f} ms, "
              f"no-exp {dev['noexp']:.4f} ms, bf16-exp {dev['bf16']:.4f} ms → exp share ≈ "
              f"{out['exp_share_device'] * 100:.1f}% of the kernels")
    sub = min(2000, K)
    errs = {tier: _f64_budget(cuda_svgd.kernel_for(D, tier), y, x, s, 1.0, sub)
            for tier in ("f32", "bf16")}
    print(f"max |φ_f32  − φ_f64| / max|φ| : {errs['f32']:.2e}")
    print(f"max |φ_bf16 − φ_f64| / max|φ| : {errs['bf16']:.2e}", flush=True)
    out.update(full_ms=t_full * 1e3, noexp_ms=t_noexp * 1e3, bf16_ms=t_bf16 * 1e3,
               exp_share=share, f32_err=errs["f32"], bf16_err=errs["bf16"])
    return out


def big_d(iters: int, device: torch.device) -> Dict:
    """The exact and bf16x3 kernels and the torch φ at the Covertype lane,
    h = 2d, and both tiers' f64 budgets."""
    rng = np.random.default_rng(0)
    y, x, s = _inputs(rng, 1, BIG_K, BIG_M, BIG_D, device)
    h = float(2 * BIG_D)  # median-scale: at h = 1 every off-diagonal K underflows
    exact, fast = cuda_svgd.kernel_for(BIG_D, "f32"), cuda_svgd.kernel_for(BIG_D, "bf16")
    best = timed_group([
        (f"{exact} (exact f32)", _step(lambda c: cuda_svgd.launch(exact, c, x, s, h))),
        (f"{fast} (bf16x3)", _step(lambda c: cuda_svgd.launch(fast, c, x, s, h))),
        ("torch φ", _step(lambda c: phi(c, x, s, RBF(h)))),
    ], y, iters)
    print(f"\nbig-d φ at ({BIG_K}, {BIG_M}, {BIG_D}), h={h}:")
    for name, t in best.items():
        print(f"  {name:32s} {_rate(BIG_K * BIG_M, t)}", flush=True)
    sub = min(200, BIG_K)
    errs = {tier: _f64_budget(cuda_svgd.kernel_for(BIG_D, tier), y, x, s, h, sub)
            for tier in ("f32", "bf16")}
    for tier, name in (("f32", "f32"), ("bf16", "bf16x3")):
        print(f"  max |φ_{name} − φ_f64| / max|φ| : {errs[tier]:.2e}", flush=True)
    return {"ms": {name: t * 1e3 for name, t in best.items()},
            "f32_err": errs["f32"], "bf16x3_err": errs["bf16"]}


def crossover(rungs: Sequence[int], t_kernel: Dict[int, float],
              t_torch: Dict[int, float]) -> Tuple[int, Optional[int]]:
    """``(line, loses_from)`` of one ladder, its rungs in pairs.

    ``loses_from`` is the first rung of the run of rungs, reaching the last
    one, where the kernel is slower than the torch φ (``None`` where it wins
    at the last rung).  ``line`` is the lower gate: the smallest rung from
    which the kernel is no slower at every rung below ``loses_from``,
    rounded down to a power of two, and 0 — no gate — where that is the
    first rung; where the kernel is slower at every rung, the power of two
    above the last.  A loss at the large rungs is kernel work, not routing:
    no upper line is drawn from it."""
    rungs = sorted(rungs)
    wins = [t_kernel[p] <= t_torch[p] for p in rungs]
    top = len(rungs)
    while top and not wins[top - 1]:
        top -= 1
    if top == 0:
        return 1 << rungs[-1].bit_length(), None
    low = top
    while low and wins[low - 1]:
        low -= 1
    line = 0 if low == 0 else 1 << (rungs[low].bit_length() - 1)
    return line, rungs[top] if top < len(rungs) else None


def gate_line(name: str, pairs: int) -> str:
    """The line to paste into ``ops/cuda_svgd.py`` for gate ``name``."""
    return f"{name} = {f'1 << {pairs.bit_length() - 1}' if pairs else 0}"


def _gate_ladder(d: int, device: torch.device) -> Tuple[Tuple[int, Optional[int]],
                                                         List[dict]]:
    """The kernel against the torch φ over the n² ladder at dim d: its
    :func:`crossover` and the rows."""
    rng = np.random.default_rng(1)
    h = 1.0 if d <= cuda_svgd.SMALL_D else float(2 * d)
    rows, t_kernel, t_torch = [], {}, {}
    for n in GATE_RUNGS:
        y, x, s = _inputs(rng, 1, n, n, d, device)
        iters = int(max(3, min(50, 6e9 / (n * n))))
        best = timed_group([
            ("kernel", _step(lambda c: cuda_svgd.phi_cuda(c, x, s, h))),
            ("torch", _step(lambda c: phi(c, x, s, RBF(h)))),
        ], y, iters)
        pairs = n * n
        t_kernel[pairs], t_torch[pairs] = best["kernel"], best["torch"]
        rows.append({"n": n, "pairs": pairs, "kernel_ms": best["kernel"] * 1e3,
                     "torch_ms": best["torch"] * 1e3})
        print(f"  d={d:4d} n={n:5d} ({pairs:>9d} pairs): {cuda_svgd.kernel_for(d)} "
              f"{best['kernel'] * 1e3:8.4f} ms, torch φ {best['torch'] * 1e3:8.4f} ms  "
              f"({best['torch'] / best['kernel']:.2f}x)", flush=True)
    return crossover(list(t_kernel), t_kernel, t_torch), rows


def harvest(device: torch.device) -> Dict:
    """(a) the split ladder's winner per shape; (b) the gate ladders and
    the two lines to paste."""
    rng = np.random.default_rng(0)
    winners = {}
    print("== (a) m-split targets (blocks per SM) per shape ==", flush=True)
    for S, k, m, d in HARVEST_SHAPES:
        y, x, s = _inputs(rng, S, k, m, d, device)
        h = 1.0 if d <= cuda_svgd.SMALL_D else float(2 * d)
        name = cuda_svgd.kernel_for(d)
        # size the chain so one timed chain is ~0.5-2 s of φ work
        iters = int(max(3, min(50, 6e9 / (S * k * m))))
        best = timed_group([
            (str(bps), _step(lambda c, b=bps: cuda_svgd.launch(name, c, x, s, h, b)))
            for bps in SPLIT_LADDER], y, iters)
        for key in sorted(best, key=best.get):
            print(f"  ({S},{k},{m},{d}) {name} {int(key):2d}/SM "
                  f"(nsplit {_nsplit(name, S, k, m, device, int(key), d)}): "
                  f"{_rate(S * k * m, best[key])}", flush=True)
        win = min(best, key=best.get)
        own = cuda_svgd.blocks_per_sm(name)
        default = best[str(own)]
        winners[(S, k, m, d)] = {"kernel": name, "best": int(win), "own": own,
                                 "best_ms": best[win] * 1e3, "default_ms": default * 1e3}
        print(f"shape ({S},{k},{m},{d}): best {win}/SM {best[win] * 1e3:.4f} ms, "
              f"the kernel's own {own}/SM {default * 1e3:.4f} ms "
              f"({default / best[win]:.3f}x)", flush=True)
    print("\n== table: the split ladder's winners (not applied: each kernel keeps "
          "its own target) ==")
    for (S, k, m, d), w in winners.items():
        print(f"    ({S}, {k}, {m}, {d}): {w['best']:2d}/SM  "
              f"# {w['best_ms']:.4f} ms vs {w['default_ms']:.4f} ms at {w['own']}/SM")

    print("\n== (b) 'auto' gates: kernel vs torch φ, S = 1, n² pairs ==", flush=True)
    gates, ladders = {}, {}
    for gate, dims in GATE_DIMS.items():
        lines = []
        for d in dims:
            (line, loses_from), ladders[d] = _gate_ladder(d, device)
            lines.append(line)
            print(f"  d={d}: line {line} pairs"
                  + (" (no gate: the kernel is no slower from the first rung)"
                     if line == 0 else "")
                  + (f"; the kernel is slower from {loses_from} pairs up: kernel "
                     "work, no upper line" if loses_from else ""), flush=True)
        gates[gate] = max(lines)
    print("\n== lines for dist_svgd_torch/ops/cuda_svgd.py ==")
    for gate, pairs in gates.items():
        print(gate_line(gate, pairs))
    return {"splits": {str(shape): w for shape, w in winners.items()},
            "ladders": ladders, "gates": gates}


def _card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "device: cpu — the plain versions on the host clock, not a card measurement"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=30).stdout.strip().splitlines()[0]
    return f"device: {torch.cuda.get_device_name(device)} ({smi})"


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m dist_svgd_torch.tools.cuda_autotune",
        description="Roofline, split sweep, no-exp ablation and 'auto' gates of the "
                    "port's φ kernels on the card.")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--big-d", action="store_true",
                    help="measure the big-d (Covertype-shape) kernels instead of the "
                         "small-d north star")
    ap.add_argument("--harvest", action="store_true",
                    help="sweep the shape ladder's splits and measure the 'auto' gates "
                         "(module docstring)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="default: the card (fails without CUDA); cpu rehearses the "
                         "tool on the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(_card_line(device), flush=True)
    if args.harvest:
        return harvest(device)
    if args.big_d:
        return big_d(args.iters, device)
    return default_mode(args.iters, args.skip_sweep, device)


if __name__ == "__main__":
    main()
