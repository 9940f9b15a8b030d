"""``DistSampler(mesh=...)`` across ``torch.distributed`` processes with the
three options a multi-process mesh now runs: the Gauss–Seidel sweep,
``kernel_approx`` and the chunked ``run_steps`` — on the CPU, gloo on
loopback, in the pattern of ``tests/test_torch_multihost.py``.

Each federation spawns W = 2 or 4 worker processes (``python -c`` with
:data:`WORKER`, the port alone) joined in one gloo group, 8 shards over
them, N = 32 particles in D = 2.  Every leg's rows are held against the
port's one-process run of the same sampler — bit for bit where no psum or
gather reorders a sum — and against JAX's ``DistSampler`` on
``multihost.make_particle_mesh(8)`` in this process at the JAX tests'
tolerances (float32: rtol 2e-6 / atol 2e-7, ``tests/test_multihost.py``;
float64: 1e-10 / 1e-12, ``tests/test_torch_approx.py``).  JAX draws its RFF
banks from threefry, which no torch stream reproduces: this process draws
JAX's banks (a run's eagerly, a step's inside ``jax.jit``) and the workers
read them through ``KernelApprox._bank_seam``, as
``tests/test_torch_approx.py`` does in one process.  The 'auto' legs on
the approximate side and the pinned checkpoint run at JAX's crossover
factor (1.0), patched in the worker.  The federations run once a width, in
module fixtures (setup), so every test call stays well inside
``tests/conftest.py``'s wall budget."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.ops import approx as japprox
from dist_svgd_tpu.parallel import multihost as jmh
from dist_svgd_tpu.utils.rng import approx_bank_key

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.ops.approx import KernelApprox

from test_torch_multihost import full_init, run_federation
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, D = 32, 2
F32 = dict(rtol=2e-6, atol=2e-7)
F64 = dict(rtol=1e-10, atol=1e-12)
#: The RFF dials of the legs (``R`` → the bank files the workers read).
RFF_R = (8, 16)
RFF_STEPS = 3
#: A federation's limit: every leg of this file in one run.
FED_TIMEOUT_S = 120

#: One federation rank: ``python -c WORKER rank W host:port outdir legs``.
#: Each leg saves its rows as ``<leg>_rows_<rank>.npy`` with
#: ``<leg>_range_<rank>.npy`` = (start, count) and, where it has them, a
#: JSON of what it measured (``<leg>_<rank>.json``).
WORKER = """
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from dist_svgd_torch import DistSampler
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.ops import approx as tapprox
from dist_svgd_torch.ops.approx import KernelApprox
from dist_svgd_torch.parallel import multihost
from dist_svgd_torch.utils.checkpoint import load_state, save_state

rank, W, coord, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
legs = sys.argv[5].split(",")
assert multihost.initialize(coord, W, rank, backend="gloo", timeout_s=60, device="cpu")
mesh = multihost.make_particle_mesh(8, device="cpu")
n, d = 32, 2
full = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
rng = np.random.default_rng(3)
xs, ts = rng.normal(size=(48, 1)), np.where(rng.normal(size=48) > 0, 1.0, -1.0)
gmm = lambda th, _: gmm_logp(th)
JAX_FACTOR, OWN_FACTOR = 1.0, tapprox.APPROX_CROSSOVER_FACTOR

def lik(th, data):
    x, t = data
    return -torch.nn.functional.softplus(-t * (x[:, 0] * th[0] + th[1])).sum()

def rows_of(arr, m=mesh, nn=n):
    s0, c = multihost.process_local_rows(nn, m)
    return multihost.make_global_particles(arr[s0:s0 + c], m, n_global=nn)

def save(name, arr, extra=None):
    rows, s0 = multihost.host_addressable_block(arr)
    np.save(os.path.join(out, f"{name}_rows_{rank}.npy"), rows)
    np.save(os.path.join(out, f"{name}_range_{rank}.npy"), np.array([s0, rows.shape[0]]))
    if extra is not None:
        with open(os.path.join(out, f"{name}_{rank}.json"), "w") as fh:
            json.dump(extra, fh)

def seam(t, shape, bandwidth):
    assert bandwidth == 1.0, bandwidth
    name = "run" if t is None else f"step{t}"
    return np.load(os.path.join(out, f"bank_{name}_{shape[0]}.npy"))

def rff(R, **kw):
    spec = KernelApprox("rff", num_features=R, **kw)
    spec._bank_seam = seam
    return spec

def sampler(p=None, **kw):
    kw.setdefault("include_wasserstein", False)
    p = rows_of(full) if p is None else p
    return DistSampler(8, kw.pop("logp", gmm), kw.pop("kernel", None), p, mesh=mesh, **kw)

def with_data(**kw):
    return sampler(rows_of(full.astype(np.float64)), logp=lik, data=(xs, ts), **kw)

GS = dict(update_rule="gauss_seidel")
W2 = dict(include_wasserstein=True, wasserstein_solver="sinkhorn", sinkhorn_iters=30)
RING = dict(exchange_impl="ring")
LEGS = {
    "gs_scores": lambda: sampler(**GS).run_steps(3, 0.1),
    "gs_particles": lambda: sampler(exchange_scores=False, **GS).run_steps(3, 0.1),
    "gs_partitions": lambda: with_data(exchange_particles=False, exchange_scores=False,
                                       **GS).run_steps(4, 0.05),
    "gs_shard_data": lambda: with_data(exchange_scores=False, shard_data=True,
                                       **GS).run_steps(3, 0.05),
    "gs_w2": lambda: sampler(**GS, **W2).run_steps(3, 0.1, h=0.5),
    "rff_gather": lambda: sampler(phi_impl="torch", kernel_approx=rff(16)).run_steps(3, 0.1),
    "rff_ring": lambda: sampler(phi_impl="torch", kernel_approx=rff(16),
                                **RING).run_steps(3, 0.1),
    "rff_step": lambda: sampler(phi_impl="torch", exchange_scores=False,
                                kernel_approx=rff(16, rff_redraw="step")).run_steps(3, 0.1),
    "nystrom_gather": lambda: sampler(phi_impl="torch", kernel_approx=KernelApprox(
        "nystrom", num_landmarks=4)).run_steps(3, 0.1),
    "nystrom_ring": lambda: sampler(phi_impl="torch", exchange_scores=False, kernel_approx=(
        KernelApprox("nystrom", num_landmarks=3)), **RING).run_steps(3, 0.1),
    "auto_exact": lambda: sampler(kernel_approx="rff").run_steps(3, 0.1),
    "auto_approx": lambda: sampler(kernel_approx=rff(8)).run_steps(3, 0.1),
}
CHUNKED = {
    "chunk_hops_scores": (dict(**RING), dict(hops_per_dispatch=3)),
    "chunk_hops_particles": (dict(exchange_scores=False, **RING),
                             dict(hops_per_dispatch=2, time_dispatches=True)),
    "chunk_budget_intra": (dict(**RING), dict(dispatch_budget=1e-9, pairs_per_sec=1e3)),
    "chunk_budget_scan": (dict(exchange_scores=False), dict(dispatch_budget=2.5,
                                                             pairs_per_sec=1e3)),
    "chunk_passes": (dict(sinkhorn_tol=1e-2, **W2), dict(max_passes_per_dispatch=7, h=0.5)),
    "chunk_ring_w2": (dict(w2_pairing="block", exchange_scores=False, **W2, **RING),
                      dict(hops_per_dispatch=3, max_passes_per_dispatch=7, h=0.5)),
}
RECORDED = {
    "gs_record": (dict(exchange_scores=False, **GS), {}),
    "chunk_record": (dict(exchange_scores=False, **RING), dict(hops_per_dispatch=2)),
}

for leg in legs:
    if leg in ("auto_approx", "approx_ckpt"):
        tapprox.APPROX_CROSSOVER_FACTOR = JAX_FACTOR
    if leg in LEGS:
        save(leg, LEGS[leg]())
    elif leg in CHUNKED:
        ctor, run = CHUNKED[leg]
        ds = sampler(**ctor)
        save(leg, ds.run_steps(4, 0.1, **run), ds.last_run_stats)
    elif leg in RECORDED:
        ctor, run = RECORDED[leg]
        final, hist = sampler(**ctor).run_steps(4, 0.1, record=True, **run)
        save(leg, final)
        np.save(os.path.join(out, f"{leg}_hist_{rank}.npy"), np.asarray(hist))
    elif leg == "gs_count":
        # one gather (and one psum in all_scores) a step, whatever the rows a shard
        counts = {}
        for nn in (32, 64):
            p = rows_of(np.random.default_rng(1).normal(size=(nn, d)).astype(np.float32),
                        nn=nn)
            for mode, kw in (("all_scores", {}), ("all_particles", dict(exchange_scores=False)),
                             ("partitions", dict(exchange_particles=False,
                                                 exchange_scores=False))):
                ds = sampler(p, **GS, **kw)
                mesh.reset_counts()
                ds.make_step(0.1)
                counts[f"{mode}_{nn}"] = mesh.counts()["collectives"]
        save(leg, sampler(**GS).particles, counts)
    elif leg == "residual":
        ds = sampler(phi_impl="torch", exchange_scores=False, kernel_approx=rff(16))
        ds.run_steps(2, 0.1)
        rep = ds.approx_residual(max_points=16)
        save(leg, ds.particles, rep)
    elif leg == "approx_ckpt":
        # 'auto' pinned approximate at JAX's factor; the save's pin wins over
        # the exact pin a sampler at the port's own factor resolves
        a = sampler(kernel_approx=rff(8))
        assert a.kernel_approx_active
        a.run_steps(2, 0.1)
        path = os.path.join(out, f"approx_ckpt_rank{rank}")
        save_state(path, a.state_dict())
        a.run_steps(2, 0.1)
        tapprox.APPROX_CROSSOVER_FACTOR = OWN_FACTOR
        b = sampler(kernel_approx=rff(8))
        pinned_before = b.kernel_approx_active
        state = load_state(path)
        b.load_state_dict(state)
        out_b = b.run_steps(2, 0.1)
        save(leg, out_b, {"saved_active": int(state["approx_active"]),
                          "pinned_before": pinned_before, "active": b.kernel_approx_active,
                          "saved_rows": int(state["particles"].shape[0]),
                          "bitwise": bool(torch.equal(out_b.rows, a.particles.rows))})
    else:
        raise ValueError(leg)
    tapprox.APPROX_CROSSOVER_FACTOR = OWN_FACTOR
multihost.shutdown()
print("ok")
"""

GS_LEGS = ("gs_scores", "gs_particles", "gs_partitions", "gs_shard_data", "gs_w2")
APPROX_LEGS = ("rff_gather", "rff_ring", "rff_step", "nystrom_gather", "nystrom_ring",
               "auto_exact", "auto_approx")
CHUNK_LEGS = ("chunk_hops_scores", "chunk_hops_particles", "chunk_budget_intra",
              "chunk_budget_scan", "chunk_passes", "chunk_ring_w2")
#: ``run_steps(record=True)`` legs: each rank's history holds its own rows.
RECORD_LEGS = ("gs_record", "chunk_record")


def jax_bank_seam(t, shape, bandwidth):
    """JAX's banks for run seed 0 (``tests/test_torch_approx.py:
    jax_bank_seam``): a run's drawn eagerly, step ``t``'s inside
    ``jax.jit``."""
    key = approx_bank_key(0)
    if t is None:
        return np.asarray(japprox.rff_frequencies(key, shape[0], shape[1], bandwidth))
    draw = jax.jit(lambda t_: japprox.rff_frequencies(
        jax.random.fold_in(key, t_), shape[0], shape[1], bandwidth))
    return np.asarray(draw(jnp.asarray(t, jnp.int32)))


def write_banks(out):
    """The banks the workers read, at bandwidth 1: a run's for each dial,
    each step's for R = 16."""
    for R in RFF_R:
        np.save(out / f"bank_run_{R}.npy", jax_bank_seam(None, (R, D), 1.0))
    for t in range(1, RFF_STEPS + 1):
        np.save(out / f"bank_step{t}_16.npy", jax_bank_seam(t, (16, D), 1.0))


def assemble(out, W: int, leg: str) -> np.ndarray:
    parts = []
    for r in range(W):
        start, _ = np.load(out / f"{leg}_range_{r}.npy")
        parts.append((int(start), np.load(out / f"{leg}_rows_{r}.npy")))
    got = np.concatenate([rows for _, rows in sorted(parts, key=lambda p: p[0])])
    assert got.shape == (N, D)
    return got


def reports(out, W: int, leg: str) -> list:
    return [json.loads((out / f"{leg}_{r}.json").read_text()) for r in range(W)]


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def fed(request, tmp_path_factory):
    """One federation a width running every leg: ``(W, outdir)``."""
    W = request.param
    out = tmp_path_factory.mktemp(f"a10_w{W}")
    write_banks(out)
    legs = (GS_LEGS + ("gs_count",) + APPROX_LEGS + ("residual", "approx_ckpt") + CHUNK_LEGS
            + RECORD_LEGS)
    run_federation(out, W, ",".join(legs), worker=WORKER, timeout_s=FED_TIMEOUT_S)
    return W, out


# ---- the references: the port on one process, JAX on make_particle_mesh(8) #

_RNG = np.random.default_rng(3)
XS, TS = _RNG.normal(size=(48, 1)), np.where(_RNG.normal(size=48) > 0, 1.0, -1.0)


def _lik(th, data):
    x, t = data
    return -torch.nn.functional.softplus(-t * (x[:, 0] * th[0] + th[1])).sum()


def _jlik(th, data):
    x, t = data
    return -jax.nn.softplus(-t * (x[:, 0] * th[0] + th[1])).sum()


def _rff(R, **kw):
    spec = KernelApprox("rff", num_features=R, **kw)
    spec._bank_seam = jax_bank_seam
    return spec


#: leg → (constructor kwargs, run_steps args, data?); JAX's spec is built
#: from the same kwargs (``kernel_approx`` mapped to JAX's with its key).
GS, W2, RING = (dict(update_rule="gauss_seidel"),
                dict(include_wasserstein=True, wasserstein_solver="sinkhorn", sinkhorn_iters=30),
                dict(exchange_impl="ring"))
LEG_SPECS = {
    "gs_scores": (dict(**GS), (3, 0.1), {}, False),
    "gs_particles": (dict(exchange_scores=False, **GS), (3, 0.1), {}, False),
    "gs_partitions": (dict(exchange_particles=False, exchange_scores=False, **GS), (4, 0.05), {},
                      True),
    "gs_shard_data": (dict(exchange_scores=False, shard_data=True, **GS), (3, 0.05), {}, True),
    "gs_w2": (dict(**GS, **W2), (3, 0.1), dict(h=0.5), False),
    "rff_gather": (dict(phi_impl="torch", kernel_approx=("rff", 16)), (3, 0.1), {}, False),
    "rff_ring": (dict(phi_impl="torch", kernel_approx=("rff", 16), **RING), (3, 0.1), {}, False),
    "rff_step": (dict(phi_impl="torch", exchange_scores=False,
                      kernel_approx=("rff", 16, "step")), (3, 0.1), {}, False),
    "nystrom_gather": (dict(phi_impl="torch", kernel_approx=("nystrom", 4)), (3, 0.1), {}, False),
    "nystrom_ring": (dict(phi_impl="torch", exchange_scores=False,
                          kernel_approx=("nystrom", 3), **RING), (3, 0.1), {}, False),
    "auto_exact": (dict(kernel_approx=("rff", 2048)), (3, 0.1), {}, False),
    "auto_approx": (dict(kernel_approx=("rff", 8)), (3, 0.1), {}, False),
    "chunk_hops_scores": (dict(**RING), (4, 0.1), dict(hops_per_dispatch=3), False),
    "chunk_hops_particles": (dict(exchange_scores=False, **RING), (4, 0.1),
                             dict(hops_per_dispatch=2, time_dispatches=True), False),
    "chunk_budget_intra": (dict(**RING), (4, 0.1), dict(dispatch_budget=1e-9,
                                                        pairs_per_sec=1e3), False),
    "chunk_budget_scan": (dict(exchange_scores=False), (4, 0.1),
                          dict(dispatch_budget=2.5, pairs_per_sec=1e3), False),
    "chunk_passes": (dict(sinkhorn_tol=1e-2, **W2), (4, 0.1),
                     dict(max_passes_per_dispatch=7, h=0.5), False),
    "chunk_ring_w2": (dict(w2_pairing="block", exchange_scores=False, **W2, **RING), (4, 0.1),
                      dict(hops_per_dispatch=3, max_passes_per_dispatch=7, h=0.5), False),
}
#: The legs at JAX's crossover factor in the worker.
AT_JAX_FACTOR = ("auto_approx",)


def _port_spec(spec):
    if spec[0] == "rff":
        return _rff(spec[1], **({"rff_redraw": spec[2]} if len(spec) > 2 else {}))
    return KernelApprox("nystrom", num_landmarks=spec[1])


def _jax_spec(spec):
    if spec[0] == "rff":
        kw = {"rff_redraw": spec[2]} if len(spec) > 2 else {}
        return japprox.KernelApprox("rff", num_features=spec[1], **kw)
    return japprox.KernelApprox("nystrom", num_landmarks=spec[1])


_PORT, _JAX = {}, {}


def port_one_process(leg):
    """``(final particles, last_run_stats)`` of the leg on one process."""
    if leg not in _PORT:
        ctor, args, run, data = LEG_SPECS[leg]
        ctor = dict(ctor)
        ctor.setdefault("include_wasserstein", False)
        if "kernel_approx" in ctor:
            ctor["kernel_approx"] = _port_spec(ctor["kernel_approx"])
        init = full_init()
        logp = lambda th, _: gmm_logp(th)  # noqa: E731
        if data:
            init, logp, ctor["data"] = init.astype(np.float64), _lik, (XS, TS)
        ds = tdt.DistSampler(8, logp, None, init, device="cpu", **ctor)
        _PORT[leg] = (ds.run_steps(*args, **run).numpy(), ds.last_run_stats)
    return _PORT[leg]


def jax_mesh_run(leg):
    """The leg's final particles from JAX's DistSampler on
    ``make_particle_mesh(8)`` in this process."""
    if leg not in _JAX:
        ctor, args, run, data = LEG_SPECS[leg]
        ctor = dict(ctor)
        ctor.setdefault("include_wasserstein", False)
        if "kernel_approx" in ctor:
            ctor["kernel_approx"] = _jax_spec(ctor["kernel_approx"])
        if ctor.get("phi_impl") == "torch":
            ctor["phi_impl"] = "xla"
        run = {k: v for k, v in run.items() if k != "time_dispatches"}
        init = full_init()
        logp = lambda th, _: jgmm_logp(th)  # noqa: E731
        if data:
            init, logp, ctor["data"] = init.astype(np.float64), _jlik, (XS, TS)
        ds = jdt.DistSampler(8, logp, None, init, mesh=jmh.make_particle_mesh(8), **ctor)
        _JAX[leg] = np.asarray(ds.run_steps(*args, **run))
    return _JAX[leg]


def _port_ref(leg, monkeypatch):
    if leg in AT_JAX_FACTOR and leg not in _PORT:
        from dist_svgd_torch.ops import approx as tapprox

        monkeypatch.setattr(tapprox, "APPROX_CROSSOVER_FACTOR",
                            japprox.APPROX_CROSSOVER_FACTOR)
    return port_one_process(leg)


def _tol(leg):
    return F64 if LEG_SPECS[leg][3] else F32


#: Legs equal to the one-process run bit for bit (no psum, gather or ring
#: hop reorders a sum across the process boundary; the W2 solves and the
#: psum'd scores are held at the float32 tolerance).
BITWISE = ("gs_particles", "gs_partitions", "gs_shard_data", "rff_step",
           "nystrom_ring", "chunk_hops_particles", "chunk_budget_scan")


# ---- the tests ---------------------------------------------------------- #


@pytest.mark.parametrize("leg", GS_LEGS + APPROX_LEGS + CHUNK_LEGS)
def test_leg_equals_the_one_process_run(fed, leg, monkeypatch):
    """Each leg across W processes against the port's one-process run."""
    W, out = fed
    got = assemble(out, W, leg)
    want, _ = _port_ref(leg, monkeypatch)
    if leg in BITWISE:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **_tol(leg))


@pytest.mark.parametrize("leg", GS_LEGS + APPROX_LEGS + CHUNK_LEGS)
def test_leg_equals_jax_on_its_mesh(fed, leg):
    """Each leg across W processes against JAX's DistSampler on
    make_particle_mesh(8), at the JAX tests' tolerances."""
    W, out = fed
    np.testing.assert_allclose(assemble(out, W, leg), jax_mesh_run(leg), **_tol(leg))


@pytest.mark.parametrize("leg,ctor,run", [
    ("gs_record", dict(exchange_scores=False, **GS), {}),
    ("chunk_record", dict(exchange_scores=False, **RING), dict(hops_per_dispatch=2))])
def test_recorded_history_is_each_ranks_rows(fed, leg, ctor, run):
    """run_steps(record=True) under the sweep and the hop chunks: each rank's
    history is its rows of every pre-update snapshot, and the ranks' rows
    together are the one-process history, bit for bit."""
    W, out = fed
    one = tdt.DistSampler(8, lambda th, _: gmm_logp(th), None, full_init(), device="cpu",
                          include_wasserstein=False, **ctor)
    final, hist = one.run_steps(4, 0.1, record=True, **run)
    np.testing.assert_array_equal(assemble(out, W, leg), final.numpy())
    parts = sorted((int(np.load(out / f"{leg}_range_{r}.npy")[0]),
                    np.load(out / f"{leg}_hist_{r}.npy")) for r in range(W))
    assert all(h.shape == (4, N // W, D) for _, h in parts)
    np.testing.assert_array_equal(np.concatenate([h for _, h in parts], axis=1),
                                  np.asarray(hist))


def test_gs_step_makes_one_gather_and_one_psum(fed):
    """A Gauss–Seidel step's collectives a rank, counted by the mesh: one
    gather (plus the frozen scores' psum in all_scores), none in
    partitions — at s = N/8 = 4 and 8 rows a shard alike."""
    W, out = fed
    for rep in reports(out, W, "gs_count"):
        assert rep == {"all_scores_32": 2, "all_scores_64": 2, "all_particles_32": 1,
                       "all_particles_64": 1, "partitions_32": 0, "partitions_64": 0}


def test_approx_residual_is_global_on_every_rank(fed, monkeypatch):
    """approx_residual gathers the ensemble: every rank publishes the one
    residual the one-process sampler measures."""
    W, out = fed
    reps = reports(out, W, "residual")
    assert all(r == reps[0] for r in reps[1:])
    one = tdt.DistSampler(8, lambda th, _: gmm_logp(th), None, full_init(), device="cpu",
                          include_wasserstein=False, exchange_scores=False, phi_impl="torch",
                          kernel_approx=_rff(16))
    one.run_steps(2, 0.1)
    np.testing.assert_array_equal(assemble(out, W, "residual"), one.particles.numpy())
    want = one.approx_residual(max_points=16)
    assert reps[0]["n_eval"] == want["n_eval"] == 16 and reps[0]["active"] is True
    for k in ("phi_approx_rel_err", "phi_approx_budget", "phi_approx_dial"):
        assert reps[0][k] == want[k], k


def test_per_process_save_keeps_the_approximation_pin(fed):
    """A per-process save of an 'auto' sampler pinned approximate restores
    into samplers whose own pin is exact: the saved pin wins, and the
    resumed tail is the uninterrupted run, bit for bit."""
    W, out = fed
    for rep in reports(out, W, "approx_ckpt"):
        assert rep == {"saved_active": 1, "pinned_before": False, "active": True,
                       "saved_rows": N // W, "bitwise": True}


@pytest.mark.parametrize("leg", CHUNK_LEGS)
def test_last_run_stats_read_the_same_on_every_rank(fed, leg, monkeypatch):
    """last_run_stats equal on every rank and to the one-process run's,
    except max_dispatch_wall_s, each rank's own (timed where asked)."""
    W, out = fed
    reps = reports(out, W, leg)
    _, want = _port_ref(leg, monkeypatch)
    timed = LEG_SPECS[leg][2].get("time_dispatches", False)
    for rep in reps:
        wall = rep.pop("max_dispatch_wall_s")
        assert (wall is not None and wall > 0) if timed else wall is None
        assert rep == {k: v for k, v in want.items() if k != "max_dispatch_wall_s"}
    assert reps[0]["execution"] == ("scan_chunks" if leg == "chunk_budget_scan"
                                    else "intra_step")
