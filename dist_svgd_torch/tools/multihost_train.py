"""Multi-process training drill: a ``torch.distributed`` process mesh,
per-process checkpoints, a kill-one-worker elastic resume — ONE
``multihost_train`` JSON row.

Counterpart of ``tools/multihost_train.py`` (same modes, same row keys,
same ``row_ok`` gates).  Two modes:

- **fake** (in one process, any device): the single-process emulation of
  the ``processes × devcount``-shard layout.  The multi-process topology is
  exercised through its seams — per-process block checkpoints cut with
  ``utils/checkpoint.py:split_state_for_processes``, reassembled with
  ``assemble_full_state``, the kill-one resume routed through
  ``reshard_state`` to the W−1 federation's shard count, and the
  coordinator loop driven with scripted
  :class:`~dist_svgd_torch.resilience.federation.FakeWorker` handles — so
  every gate (bitwise resume, RNG layout-freeness, steps lost, no capture
  or kernel build after the restart) runs without a rendezvous;
- **real**: W worker processes (``python -m
  dist_svgd_torch.tools.multihost_worker``) join one gloo or NCCL group,
  train through cross-process collectives and save per-process blocks;
  one worker takes a real SIGKILL once the federation's first complete
  save is on disk (the ranks hold there, ``--hold-at``, so the kill lands
  at a known step), and
  :class:`~dist_svgd_torch.resilience.federation.FederationSupervisor`
  drains the survivors and relaunches W−1 of them with ``--resume``.  The
  final rows are held against one uninterrupted single-process run from
  the same initial particles.  A request
  :func:`~dist_svgd_torch.parallel.multihost.multiprocess_gap` refuses
  (NCCL with more ranks than cards) is an up-front ``unsupported`` row; a
  federation that dies past its restart budget, or that outlives
  ``--deadline-s``, raises, and ``main`` exits non-zero.

"Recompiles" is ``parallel/plan.py:capture_sentry``'s count (CUDA-graph
captures and hand-kernel builds) where JAX counts XLA compiles.

Usage (the card unless ``--device cpu``; on one card several ranks share
it under ``--backend gloo``)::

    python -m dist_svgd_torch.tools.multihost_train --mode fake     # one process
    python -m dist_svgd_torch.tools.multihost_train --mode real --processes 4 \\
        --backend gloo                                               # 4 workers

``--mode auto`` (the default) is JAX's: real unless the group is refused.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

DEFAULT_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[2]


def build_sampler(n, num_shards, mesh=None, *, exchange_impl="gather", include_w2=False,
                  kernel_approx=None, seed=0, device=None, particles=None):
    """The drill's sampler: the GMM posterior, gathered particles with local
    scores (the shard-count-invariant mode the elastic drill pins), on
    ``mesh`` (the single-process emulation by default)."""
    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.models.gmm import gmm_logp
    from dist_svgd_torch.utils.rng import init_particles_per_shard

    if particles is None:
        particles = init_particles_per_shard(seed, n, 2, num_shards)
    return DistSampler(
        num_shards, lambda th, _: gmm_logp(th), None, particles,
        exchange_particles=True, exchange_scores=False,
        include_wasserstein=include_w2,
        wasserstein_solver="sinkhorn" if include_w2 else "lp",
        sinkhorn_iters=20, exchange_impl=exchange_impl, mesh=mesh,
        kernel_approx=kernel_approx, device=device)


def _rows(ds):
    from dist_svgd_torch.parallel.multihost import host_addressable_block

    return host_addressable_block(ds.particles)[0]


def _sync(ds):
    import torch

    if ds.device.type == "cuda":
        torch.cuda.synchronize(ds.device)


def _timed_updates_per_s(ds, steps, step_size, n):
    """Particle-updates/s over ``steps`` warmed steps (one untimed step
    first, so a kernel build never lands in the window)."""
    ds.run_steps(1, step_size)
    _sync(ds)
    w0 = time.perf_counter()
    ds.run_steps(steps, step_size)
    _sync(ds)
    wall = time.perf_counter() - w0
    return n * steps / max(wall, 1e-9), wall / steps


def _fake_federation_report():
    """The coordinator loop through a scripted kill-one lifecycle:
    generation 0 loses worker 1 (SIGKILL-shaped rc −9), the relaunched W−1
    generation finishes clean."""
    from dist_svgd_torch.resilience import FakeWorker, FederationSupervisor
    from dist_svgd_torch.telemetry import MetricsRegistry

    def launcher(width, attempt):
        if attempt == 0:
            return [FakeWorker(f"rank{i}", [None, None, -9 if i == 1 else None, None, 0])
                    for i in range(width)]
        return [FakeWorker(f"rank{i}", [None, 0]) for i in range(width)]

    sup = FederationSupervisor(launcher, processes=4, restart_budget=1,
                               registry=MetricsRegistry(), clock=time.perf_counter,
                               sleep=lambda s: None)
    report = sup.run()
    return {"restarts": report["restarts"], "final_processes": report["processes"],
            "transitions": [{k: v for k, v in t.items() if k != "lost"}
                            for t in report["transitions"]]}


def _platform(device) -> str:
    import torch

    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def run_drill(mode="auto", processes=4, devcount=2, n=288, num_steps=24,
              checkpoint_every=8, kill_step=None, step_size=0.05, timed_steps=8,
              tol=DEFAULT_TOL, root=None, seed=0, device=None, backend=None,
              deadline_s=600.0):
    """Run the drill; returns the ``multihost_train`` row.  ``mode`` is
    ``'fake'``, ``'real'`` or JAX's ``'auto'`` (real unless
    :func:`~dist_svgd_torch.parallel.multihost.multiprocess_gap` refuses
    the group, then fake)."""
    from dist_svgd_torch.parallel import multihost
    from dist_svgd_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    dev_kind = dev.type
    gap = multihost.multiprocess_gap(processes, backend, dev_kind)
    if mode == "auto":
        mode = "fake" if gap else "real"
    if mode == "real":
        if gap is not None:
            return {"metric": "multihost_train", "mode": "real", "status": "unsupported",
                    "unsupported_reason": gap}
        return _run_real(processes=processes, devcount=devcount, n=n, num_steps=num_steps,
                         checkpoint_every=checkpoint_every, step_size=step_size, tol=tol,
                         root=root, seed=seed, device=dev_kind, backend=backend,
                         deadline_s=deadline_s)
    if mode != "fake":
        raise ValueError(f"unknown mode {mode!r}")
    return _run_fake(processes=processes, devcount=devcount, n=n, num_steps=num_steps,
                     checkpoint_every=checkpoint_every, kill_step=kill_step,
                     step_size=step_size, timed_steps=timed_steps, tol=tol, root=root,
                     seed=seed, device=dev)


def _run_fake(*, processes, devcount, n, num_steps, checkpoint_every, kill_step, step_size,
              timed_steps, tol, root, seed, device):
    import numpy as np

    from dist_svgd_torch.ops.approx import KernelApprox
    from dist_svgd_torch.parallel import multihost
    from dist_svgd_torch.parallel.exchange import ring_hops_per_step
    from dist_svgd_torch.parallel.plan import capture_sentry
    from dist_svgd_torch.utils import checkpoint as ckpt

    if root is None:
        import tempfile

        root = tempfile.mkdtemp(prefix="multihost_train_")
    shards = processes * devcount
    shards_after = (processes - 1) * devcount
    if n % shards or n % shards_after:
        raise ValueError(f"n ({n}) must divide both the W ({shards}) and W-1 "
                         f"({shards_after}) shard counts")
    if kill_step is None:
        # strictly between two checkpoints: the resume must replay steps
        kill_step = 2 * checkpoint_every + max(1, checkpoint_every // 2)
    if not checkpoint_every < kill_step < num_steps:
        raise ValueError(f"kill_step ({kill_step}) must land inside "
                         f"({checkpoint_every}, {num_steps})")
    ckpt_before_kill = (kill_step // checkpoint_every) * checkpoint_every
    mesh = multihost.make_particle_mesh(shards)

    def sampler(num_shards=shards, m=mesh, **kw):
        return build_sampler(n, num_shards, m, seed=seed, device=device, **kw)

    # -------- arms: gather + ring perf, W2 / kernel-approx legs -------- #
    gather_ups, gather_step_wall = _timed_updates_per_s(sampler(), timed_steps, step_size, n)
    ring_ups, ring_step_wall = _timed_updates_per_s(sampler(exchange_impl="ring"),
                                                    timed_steps, step_size, n)
    hops = ring_hops_per_step("all_particles", shards)
    variants_ok = True
    for kw in ({"include_w2": True},
               {"kernel_approx": KernelApprox("rff", num_features=64),
                "exchange_impl": "ring"}):
        v = sampler(**kw)
        v.run_steps(2, step_size)
        variants_ok = variants_ok and bool(np.isfinite(_rows(v)).all())

    # -------- multi-process-topology resume: bitwise vs uninterrupted -- #
    base = sampler()
    base.run_steps(num_steps, step_size)
    final_base = _rows(base)

    saver = sampler()
    saver.run_steps(ckpt_before_kill, step_size)
    blocks = ckpt.split_state_for_processes(saver.state_dict(), processes)
    paths = [ckpt.save_state(os.path.join(root, f"step_{ckpt_before_kill}", f"rank_{r}"), blk)
             for r, blk in enumerate(blocks)]
    # a lone foreign-layout block must be rejected, not half-restored
    single_block_rejected = False
    try:
        sampler().load_state_dict(ckpt.load_state(paths[0]))
    except ValueError:
        single_block_rejected = True
    assembled = ckpt.assemble_full_state(paths)
    resumed = sampler()
    resumed.load_state_dict(assembled)
    resumed.run_steps(num_steps - ckpt_before_kill, step_size)
    resume_bitwise = bool(np.array_equal(_rows(resumed), final_base))
    rng_layout_free = bool(np.array_equal(resumed.state_dict()["rng_batch_seed"],
                                          base.state_dict()["rng_batch_seed"]))
    man = ckpt.read_manifest(blocks[0])
    manifest_stamped = bool(man is not None and man["process_count"] == processes
                            and man["granule_shards"].tolist() == [devcount] * processes)

    # -------- kill-one-worker: resume at W−1 on the same step grid ----- #
    t_kill_detect = time.perf_counter()
    resharded = ckpt.reshard_state(assembled, shards_after)
    survivor = sampler(shards_after, multihost.make_particle_mesh(shards_after))
    survivor.load_state_dict(resharded)
    resumed_from = survivor.t
    steps_lost = kill_step - resumed_from
    # the first half builds what the W−1 layout needs; the second must
    # capture and build nothing
    remaining = num_steps - resumed_from
    seg = remaining // 2
    survivor.run_steps(seg, step_size)
    with capture_sentry("post-restart steady state") as sentry:
        survivor.run_steps(remaining - seg, step_size)
        _sync(survivor)
    killone_recovery_wall_s = time.perf_counter() - t_kill_detect
    killone_max_dev = float(np.abs(_rows(survivor) - final_base).max())

    fed = _fake_federation_report()
    return {
        "metric": "multihost_train",
        "mode": "fake",
        "status": "ok",
        "unsupported_reason": None,
        "platform": _platform(device),
        "processes": processes,
        "devcount": devcount,
        "shards": shards,
        "shards_after_loss": shards_after,
        "n": n,
        "num_steps": num_steps,
        "checkpoint_every": checkpoint_every,
        "updates_per_s_gather": round(gather_ups, 1),
        "updates_per_s_ring": round(ring_ups, 1),
        "updates_per_s_multi": None,  # real mode only: the W-process arm
        "gather_step_wall_ms": round(gather_step_wall * 1e3, 3),
        "ring_step_wall_ms": round(ring_step_wall * 1e3, 3),
        "ring_hops_per_step": hops["hops"],
        "ring_hop_wall_ms": round(ring_step_wall * 1e3 / max(hops["hops"], 1), 4),
        "dcn_crossings_per_hop": multihost.dcn_boundary_crossings(mesh),
        "variants_ok": bool(variants_ok),
        "manifest_stamped": manifest_stamped,
        "single_block_rejected": bool(single_block_rejected),
        "resume_bitwise": resume_bitwise,
        "rng_layout_free": rng_layout_free,
        "kill_step": kill_step,
        "resumed_from": int(resumed_from),
        "steps_lost": int(steps_lost),
        "expected_steps_lost": kill_step - ckpt_before_kill,
        "killone_to_shards": shards_after,
        "killone_max_dev": killone_max_dev,
        "killone_within_tol": bool(killone_max_dev <= tol),
        "killone_recovery_wall_s": round(killone_recovery_wall_s, 4),
        # the port's sentry counts CUDA-graph captures and hand-kernel
        # builds where JAX's counts XLA compiles
        "post_restart_recompiles": sentry.compiles,
        "sentry_supported": sentry.supported,
        "federation_restarts": fed["restarts"],
        "federation_final_processes": fed["final_processes"],
        "federation_transitions": fed["transitions"],
    }




def worker_command(rank, width, coordinator, root, *, devcount, n, num_steps,
                   checkpoint_every, step_size, seed, device, backend, resume, hold_at):
    """The command line of one worker rank."""
    cmd = [sys.executable, "-m", "dist_svgd_torch.tools.multihost_worker",
           "--rank", str(rank), "--nprocs", str(width), "--coordinator", coordinator,
           "--root", str(root), "--devcount", str(devcount), "--n", str(n),
           "--steps", str(num_steps), "--checkpoint-every", str(checkpoint_every),
           "--step-size", str(step_size), "--seed", str(seed), "--device", device]
    if backend is not None:
        cmd += ["--backend", backend]
    if resume:
        cmd.append("--resume")
    if hold_at is not None:
        cmd += ["--hold-at", str(hold_at)]
    return cmd


class _KillTrigger:
    """The kill-one seam: wraps a worker handle and delivers a real SIGKILL
    the first time the federation's first complete per-process save is on
    disk (the ranks hold after it), so the resumed W−1 generation has
    something to assemble; :class:`FederationSupervisor` stays
    unmodified."""

    def __init__(self, inner, root: str, step: int, nprocs: int):
        self._inner = inner
        self._root = root
        self._step = int(step)
        self._nprocs = int(nprocs)
        self.name = inner.name
        self.triggered = False

    def _save_complete(self) -> bool:
        d = os.path.join(self._root, f"step_{self._step}")
        return all(os.path.isdir(os.path.join(d, f"rank_{r}")) for r in range(self._nprocs))

    def poll(self):
        if not self.triggered and self._save_complete():
            self.triggered = True
            self._inner.kill()  # real SIGKILL on the Popen
        return self._inner.poll()

    def kill(self):
        self._inner.kill()

    def wait(self, timeout_s: float = 30.0):
        return self._inner.wait(timeout_s)


class _Deadline:
    """A worker handle whose :meth:`poll` raises once the drill's deadline
    has passed: a hung federation ends as a failure, never as a wait."""

    def __init__(self, inner, deadline: float):
        self._inner = inner
        self._deadline = deadline
        self.name = inner.name

    def poll(self):
        rc = self._inner.poll()
        if rc is None and time.monotonic() > self._deadline:
            raise TimeoutError(f"worker {self.name} still running at the drill's deadline")
        return rc

    def kill(self):
        self._inner.kill()

    def wait(self, timeout_s: float = 30.0):
        return self._inner.wait(timeout_s)


def _run_real(*, processes, devcount, n, num_steps, checkpoint_every, step_size, tol, root,
              seed, device, backend, deadline_s):
    import numpy as np

    from dist_svgd_torch.parallel import multihost
    from dist_svgd_torch.resilience import FederationSupervisor, SubprocessWorker
    from dist_svgd_torch.telemetry import MetricsRegistry
    from dist_svgd_torch.tools.multihost_worker import drill_init
    from dist_svgd_torch.utils.ports import listen_port

    if root is None:
        import tempfile

        root = tempfile.mkdtemp(prefix="multihost_train_real_")
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    deadline = time.monotonic() + deadline_s
    logs, popens = [], []

    def launcher(width, attempt):
        coord = f"127.0.0.1:{listen_port()}"
        handles = []
        for r in range(width):
            cmd = worker_command(r, width, coord, root, devcount=devcount, n=n,
                                 num_steps=num_steps, checkpoint_every=checkpoint_every,
                                 step_size=step_size, seed=seed, device=device,
                                 backend=backend, resume=attempt > 0,
                                 hold_at=checkpoint_every if attempt == 0 else None)
            log = open(os.path.join(root, f"gen{attempt}_rank{r}.log"), "w")
            logs.append(log)
            p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
            popens.append(p)
            handles.append(_Deadline(SubprocessWorker(f"rank{r}", p), deadline))
        if attempt == 0:
            handles[1] = _KillTrigger(handles[1], root, step=checkpoint_every, nprocs=width)
        return handles

    sup = FederationSupervisor(launcher, processes=processes, restart_budget=1,
                               poll_interval_s=0.1, registry=MetricsRegistry())
    t0 = time.perf_counter()
    try:
        report = sup.run()
    finally:
        for p in popens:  # no worker outlives the drill
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    done = []
    for r in range(report["processes"]):
        with open(os.path.join(root, f"done_rank{r}.json")) as fh:
            done.append(json.load(fh))
    rows = [np.load(os.path.join(root, f"final_rows_{r}.npy")) for r in range(report["processes"])]
    final_multi = np.concatenate([rows[i] for i in np.argsort([d["row_start"] for d in done])])

    # the single-process arm at the same global shape and initial particles
    shards = processes * devcount
    init = drill_init(n, seed)
    single = build_sampler(n, shards, seed=seed, device=device, particles=init)
    ups_single, _ = _timed_updates_per_s(single, checkpoint_every, step_size, n)
    base = build_sampler(n, shards, seed=seed, device=device, particles=init)
    base.run_steps(num_steps, step_size)
    max_dev = float(np.abs(_rows(base) - final_multi).max())
    walls = [d["step_wall_s"] for d in done if d["step_wall_s"]]
    return {
        "metric": "multihost_train",
        "mode": "real",
        "status": "ok",
        "unsupported_reason": None,
        "platform": _platform(device),
        "backend": done[0]["backend"] if done else backend,
        "processes": processes,
        "devcount": devcount,
        "shards": shards,
        "shards_after_loss": (processes - 1) * devcount,
        "n": n,
        "num_steps": num_steps,
        "checkpoint_every": checkpoint_every,
        "updates_per_s_gather": round(ups_single, 1),
        "updates_per_s_multi": round(n / float(np.median(walls)), 1) if walls else None,
        "dcn_crossings_per_hop": done[0]["dcn_crossings_per_hop"] if done else None,
        "resume_t_complete": all(d["t"] == num_steps for d in done),
        "resumed_from": done[0]["resumed_from"] if done else None,
        "killone_max_dev": max_dev,
        "killone_within_tol": bool(max_dev <= tol),
        "federation_restarts": report["restarts"],
        "federation_final_processes": report["processes"],
        "federation_transitions": [{k: v for k, v in t.items() if k != "lost"}
                                   for t in report["transitions"]],
        "worker_phi_launches": [d["phi_launches"] for d in done],
        "worker_staged_bytes": [d["mesh_counts"]["staged_bytes"] for d in done],
        "drill_wall_s": round(time.perf_counter() - t0, 2),
    }


def row_ok(row):
    """``(ok, reasons)``: the drill's own acceptance — JAX's gates.  An
    up-front refusal (``status='unsupported'``) is OK with its reason
    recorded: saying so cleanly is the contract."""
    if row.get("status") == "unsupported":
        return True, [f"unsupported: {row.get('unsupported_reason')}"]
    reasons = []
    if row.get("mode") == "fake":
        if not row.get("resume_bitwise"):
            reasons.append("multi-process-topology resume is not bitwise")
        if not row.get("rng_layout_free"):
            reasons.append("minibatch RNG root changed across layouts")
        if not row.get("manifest_stamped"):
            reasons.append("process layout missing from the manifest")
        if not row.get("single_block_rejected"):
            reasons.append("a lone per-process block restored silently")
        if not row.get("variants_ok"):
            reasons.append("a W2/kernel-approx variant went non-finite")
        if row.get("steps_lost") != row.get("expected_steps_lost"):
            reasons.append(f"steps_lost {row.get('steps_lost')} != expected "
                           f"{row.get('expected_steps_lost')}")
        if row.get("sentry_supported") and row.get("post_restart_recompiles", 0) != 0:
            reasons.append(f"{row['post_restart_recompiles']} post-restart steady-state "
                           "capture(s) or kernel build(s)")
    else:
        if not row.get("resume_t_complete"):
            reasons.append("a surviving worker did not regain the full step grid")
        if row.get("federation_restarts") != 1:
            reasons.append(f"expected exactly one federation restart, got "
                           f"{row.get('federation_restarts')}")
    if not row.get("killone_within_tol"):
        reasons.append(f"kill-one resume diverged (max dev {row.get('killone_max_dev')})")
    return not reasons, reasons


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.multihost_train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("auto", "fake", "real"), default="auto")
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--devcount", type=int, default=2, help="shards a worker process")
    ap.add_argument("--n", type=int, default=288)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--kill-step", type=int, default=None)
    ap.add_argument("--stepsize", type=float, default=0.05)
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="real mode: default nccl on the card, gloo on the CPU")
    ap.add_argument("--deadline-s", type=float, default=600.0,
                    help="real mode: the federation's wall limit")
    args = ap.parse_args(argv)

    row = run_drill(mode=args.mode, processes=args.processes, devcount=args.devcount,
                    n=args.n, num_steps=args.steps, checkpoint_every=args.checkpoint_every,
                    kill_step=args.kill_step, step_size=args.stepsize, tol=args.tol,
                    root=args.root, device=args.device, backend=args.backend,
                    deadline_s=args.deadline_s)
    ok, reasons = row_ok(row)
    row["ok"] = ok
    row["fail_reasons"] = reasons if not ok else []
    print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
