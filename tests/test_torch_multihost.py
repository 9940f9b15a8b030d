"""The process mesh (``dist_svgd_torch/parallel/mesh.py``,
``parallel/multihost.py``) and ``DistSampler(mesh=...)`` across processes,
on the CPU: gloo on loopback.

Single-process cases hold the rendezvous refusals, the mesh layout, the
global/local row round trips and the ring's accounting against JAX's
(``tests/test_multihost.py``), and a one-process ``ParticleMesh`` against
``mesh=None`` bit for bit.  The federations spawn 2 or 4 worker processes
(``python -c`` with :data:`WORKER`, the port alone) that join one gloo
group; their rows are held against JAX's ``DistSampler`` on
``multihost.make_particle_mesh(8)`` in this process at JAX's own tolerances
(rtol 2e-6 / atol 2e-7; the restore at 1e-6 / 1e-7), and the legs JAX's
workers do not run (minibatches with ``shard_data`` and ``log_prior``, the
Sinkhorn W2 term, the ring's block pairing) against the port's own
single-process run.  A worker that outlives its federation is killed.  Each
federation runs once, in a module fixture (a rank's import and first step
take ~5 s of the ~6 s a federation takes on an idle CPU), so every test
stays well inside ``tests/conftest.py``'s wall budget."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.parallel import exchange as jexchange
from dist_svgd_tpu.parallel import multihost as jmh

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.parallel import exchange, multihost
from dist_svgd_torch.parallel.mesh import GlobalRows, ParticleMesh
from dist_svgd_torch.utils import checkpoint as ckpt

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
N, D = 32, 2
FED_TIMEOUT_S = 60

#: One federation rank: ``python -c WORKER rank W host:port outdir legs``.
#: It joins the gloo group, runs the comma-separated legs on the shared
#: deterministic init and saves its rows of each result as
#: ``<leg>_rows_<rank>.npy`` with ``<leg>_range_<rank>.npy`` = (start, count).
WORKER = textwrap.dedent("""
    import glob, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from dist_svgd_torch import DistSampler
    from dist_svgd_torch.models.gmm import gmm_logp
    from dist_svgd_torch.parallel import multihost
    from dist_svgd_torch.utils.checkpoint import assemble_full_state, load_state, save_state

    rank, W, coord, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    legs = sys.argv[5].split(",")
    assert multihost.initialize(coord, W, rank, backend="gloo", timeout_s=60, device="cpu")
    mesh = multihost.make_particle_mesh(8, device="cpu")
    n, d = 32, 2
    full = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    start, count = multihost.process_local_rows(n, mesh)
    parts = multihost.make_global_particles(full[start:start + count], mesh, n_global=n)
    gmm = lambda th, _: gmm_logp(th)

    def save(name, arr):
        rows, s0 = multihost.host_addressable_block(arr)
        np.save(os.path.join(out, f"{name}_rows_{rank}.npy"), rows)
        np.save(os.path.join(out, f"{name}_range_{rank}.npy"), np.array([s0, rows.shape[0]]))

    def sampler(m=mesh, p=parts, **kw):
        kw.setdefault("include_wasserstein", False)
        return DistSampler(m.num_shards, kw.pop("logp", gmm), kw.pop("kernel", None), p,
                           mesh=m, **kw)

    def w2():
        return sampler(include_wasserstein=True, wasserstein_solver="sinkhorn",
                       sinkhorn_iters=50)

    rng = np.random.default_rng(3)
    xs, ts = rng.normal(size=(48, 1)), np.where(rng.normal(size=48) > 0, 1.0, -1.0)
    p64 = multihost.make_global_particles(full[start:start + count].astype(np.float64), mesh,
                                          n_global=n)
    def lik(th, data):
        x, t = data
        return -torch.nn.functional.softplus(-t * (x[:, 0] * th[0] + th[1])).sum()

    for leg in legs:
        if leg == "gather":
            save(leg, sampler().run_steps(5, 0.1))
        elif leg == "ring":
            save(leg, sampler(exchange_impl="ring").run_steps(4, 0.1))
        elif leg == "lagged":
            save(leg, sampler(exchange_scores=False, exchange_every=2).run_steps(4, 0.1))
        elif leg == "subset":
            sub = multihost.make_particle_mesh(W, device="cpu")
            s0, c = multihost.process_local_rows(n, sub)
            p = multihost.make_global_particles(full[s0:s0 + c], sub, n_global=n)
            save(leg, sampler(sub, p, exchange_scores=False).run_steps(4, 0.1))
        elif leg == "minibatch":
            ds = sampler(p=p64, logp=lik, data=(xs, ts), exchange_scores=False,
                         shard_data=True, batch_size=3, seed=7,
                         log_prior=lambda th: -0.5 * (th * th).sum())
            save(leg, ds.run_steps(4, 0.05))
        elif leg == "w2":
            ds = w2()
            save(leg, ds.run_steps(4, 0.1, h=0.5))
        elif leg == "partitions":
            save(leg, sampler(exchange_particles=False, exchange_scores=False).run_steps(4, 0.1))
        elif leg == "partitions_w2_data":
            ds = sampler(p=p64, logp=lik, data=(xs, ts), exchange_particles=False,
                         exchange_scores=False, include_wasserstein=True,
                         wasserstein_solver="sinkhorn", sinkhorn_iters=30)
            save(leg, ds.run_steps(4, 0.05, h=0.5))
        elif leg == "ring_w2_block":
            ds = sampler(exchange_impl="ring", exchange_scores=False, include_wasserstein=True,
                         wasserstein_solver="sinkhorn", sinkhorn_iters=30,
                         w2_pairing="block", kernel="median_step")
            save(leg, ds.run_steps(4, 0.1, h=0.5))
        elif leg == "ckpt":
            # one sampler plays both roles: 3 steps, save this rank's block,
            # 2 more — its end IS the uninterrupted run
            straight = w2()
            straight.run_steps(3, 0.1, h=0.5)
            path = os.path.join(out, f"ckpt_rank{rank}")
            save_state(path, straight.state_dict())
            straight.run_steps(2, 0.1, h=0.5)
            save("ckpt_want", straight.particles)
            state = load_state(path)
            assert state["particles"].shape[0] == count, state["particles"].shape
            resumed = w2()
            resumed.load_state_dict(state)
            resumed.run_steps(2, 0.1, h=0.5)
            assert np.array_equal(resumed.particles.rows.numpy(), straight.particles.rows.numpy())
        elif leg == "ckpt_restore":
            paths = sorted(glob.glob(os.path.join(out, "ckpt_rank*")))
            assert len(paths) not in (0, W), paths
            try:
                w2().load_state_dict(load_state(paths[0]))
            except ValueError as e:
                assert "matches neither" in str(e), e
            else:
                raise AssertionError("a lone foreign-layout block restored")
            resumed = w2()
            resumed.load_state_dict(assemble_full_state(paths))
            resumed.run_steps(2, 0.1, h=0.5)
            save("cross", resumed.particles)
        else:
            raise ValueError(leg)
    multihost.shutdown()
    print("ok")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_federation(outdir, nprocs: int, legs: str):
    """Spawn ``nprocs`` WORKER ranks on a fresh loopback port; every rank
    must exit 0 within FED_TIMEOUT_S, and none outlives this call."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(nprocs), coord,
                               str(outdir), legs], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(nprocs)]
    try:
        logs = [p.communicate(timeout=FED_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:  # a rank that died leaves its peers blocked
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"


def assemble(outdir, nprocs: int, name: str) -> np.ndarray:
    got = np.full((N, D), np.nan, dtype=np.float64)
    for r in range(nprocs):
        start, count = np.load(outdir / f"{name}_range_{r}.npy")
        rows = np.load(outdir / f"{name}_rows_{r}.npy")
        got = got.astype(rows.dtype)
        got[start:start + count] = rows
    assert not np.isnan(got).any()
    return got


def full_init() -> np.ndarray:
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


def jax_run(num_shards, steps, **kw):
    ref = jdt.DistSampler(num_shards, lambda th, _: jgmm_logp(th), None, full_init(),
                          include_wasserstein=False, mesh=jmh.make_particle_mesh(num_shards),
                          **kw)
    return np.asarray(ref.run_steps(steps, 0.1))


# ---- single process ---------------------------------------------------- #


def test_multiprocess_gap_matrix(monkeypatch):
    """Single-process requests are never gapped; gloo on the CPU is fine;
    NCCL is refused before any rendezvous with more ranks than cards, or
    where the build has no NCCL, each naming backend="gloo"."""
    assert multihost.multiprocess_gap(None) is None
    assert multihost.multiprocess_gap(1, backend="nccl") is None
    assert multihost.multiprocess_gap(4, backend="gloo", device="cpu") is None
    assert multihost.multiprocess_gap(2, device="cpu") is None  # gloo on the CPU
    assert "CUDA is not available" in multihost.multiprocess_gap(2, backend="gloo")
    gap = multihost.multiprocess_gap(2, backend="nccl")
    assert 'backend="gloo"' in gap and "one rank a card" in gap
    assert 'backend="gloo"' in multihost.multiprocess_gap(2, backend="nccl", device="cpu")
    # a host with one card: two NCCL ranks collide ("Duplicate GPU detected")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    gap = multihost.multiprocess_gap(2, backend="nccl")
    assert "2 ranks on this host have 1 card" in gap and 'backend="gloo"' in gap
    assert multihost.multiprocess_gap(2, backend="gloo") is None  # every rank on cuda:0
    assert multihost.multiprocess_gap(2, backend="nccl", local_processes=1) == (
        None if torch.distributed.is_nccl_available()
        else 'NCCL is not available in this torch build: pass backend="gloo"')


def test_backend_and_process_device_rules():
    assert multihost.resolve_backend(None, "cpu") == "gloo"
    assert multihost.resolve_backend(None, None) == "nccl"
    assert multihost.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.resolve_backend("mpi")
    assert multihost.process_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.process_device(0)


def test_initialize_is_noop_single_process():
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    mesh = multihost.make_particle_mesh(8)
    assert (mesh.process_count, mesh.shards_per_process, mesh.distributed) == (1, 8, False)
    with pytest.raises(ValueError, match="needs a coordinator"):
        multihost.initialize(num_processes=2, process_id=0)


def test_initialize_raises_for_a_coordinator_it_cannot_honour():
    """A malformed address, a refused backend and a coordinator nobody
    answers (a free loopback port, one-second timeout) all raise — never a
    quiet single-process run."""
    with pytest.raises(ValueError, match="HOST:PORT"):
        multihost.initialize("127.0.0.1", 2, 0, device="cpu")
    with pytest.raises(RuntimeError, match='backend="gloo"'):
        multihost.initialize(f"127.0.0.1:{_free_port()}", 2, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="failed"):
        multihost.initialize(f"127.0.0.1:{_free_port()}", 2, 1, backend="gloo",
                             timeout_s=1.0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_particle_mesh_layout_and_overflow():
    m = ParticleMesh(8, world_size=4, rank=2, device="cpu", backend="gloo", distributed=True)
    assert (m.first_shard, m.shards_per_process, m.process_count) == (4, 2, 4)
    assert m.lanes("cpu").tolist() == [4, 5]
    assert m.local_lanes(torch.arange(8)).tolist() == [4, 5]
    assert not m.stages_through_host  # gloo on the CPU: already host memory
    assert ParticleMesh(8, 2, 0, "cuda", "gloo", distributed=True).stages_through_host
    assert not ParticleMesh(8, 2, 0, "cuda", "nccl", distributed=True).stages_through_host
    with pytest.raises(ValueError, match="multiple of the 4 processes"):
        ParticleMesh(6, world_size=4, rank=0, distributed=True)
    with pytest.raises(ValueError, match="rank 4"):
        ParticleMesh(8, world_size=4, rank=4, distributed=True)
    with pytest.raises(ValueError, match="distributed=True"):
        ParticleMesh(8, world_size=2)
    with pytest.raises(ValueError, match="need num_shards"):
        ParticleMesh(0)


def test_process_local_rows():
    assert multihost.process_local_rows(64, multihost.make_particle_mesh(8)) == (0, 64)
    m = ParticleMesh(8, world_size=4, rank=2, distributed=True)
    assert multihost.process_local_rows(64, m) == (32, 16)
    assert jmh.process_local_rows(64, jmh.make_particle_mesh(8)) == (0, 64)


def test_global_local_roundtrip_nondividing_rows():
    """Rows that do not divide the shards are refused at placement; a ragged
    5-shard mesh that divides round-trips exactly (JAX's case)."""
    rows = np.arange(10 * 2, dtype=np.float64).reshape(10, 2)
    with pytest.raises(ValueError, match="divisible"):
        multihost.make_global_from_local(rows, multihost.make_particle_mesh(8), (10, 2))
    arr = multihost.make_global_from_local(rows, multihost.make_particle_mesh(5), (10, 2))
    block, start = multihost.host_addressable_block(arr)
    assert start == 0 and arr.shape == (10, 2)
    np.testing.assert_array_equal(block, rows)
    with pytest.raises(ValueError, match="single-process local block"):
        multihost.make_global_from_local(rows[:4], multihost.make_particle_mesh(5), (10, 2))
    # a process's block of a multi-process layout
    m = ParticleMesh(4, world_size=2, rank=1, distributed=True)
    blk = multihost.make_global_particles(rows[6:], m, n_global=8)
    assert (blk.start, blk.n_global, blk.shape) == (4, 8, (8, 2))
    assert multihost.host_addressable_block(blk)[1] == 4
    with pytest.raises(ValueError, match="local block"):
        multihost.make_global_particles(rows[:3], m, n_global=8)


def test_global_local_roundtrip_single_shard_mesh():
    mesh = multihost.make_particle_mesh(1)
    rows = np.arange(6 * 3, dtype=np.float64).reshape(6, 3)
    assert multihost.process_local_rows(6, mesh) == (0, 6)
    arr = multihost.make_global_particles(rows, mesh, n_global=6)
    block, start = multihost.host_addressable_block(arr)
    assert start == 0
    np.testing.assert_array_equal(block, rows)
    with pytest.raises(ValueError, match="n_global 7"):
        multihost.make_global_particles(rows, mesh, n_global=7)
    assert multihost.host_addressable_block(torch.ones(2))[1] == 0
    np.testing.assert_array_equal(multihost.replicate(rows, mesh).numpy(), rows)


def test_mesh_process_layout():
    assert multihost.mesh_process_layout(multihost.make_particle_mesh(8)) == (1, (8,))
    assert multihost.mesh_process_layout(
        ParticleMesh(8, world_size=4, rank=0, distributed=True)) == (4, (2, 2, 2, 2))
    assert jmh.mesh_process_layout(jmh.make_particle_mesh(8)) == (1, (8,))


def test_dcn_boundary_crossings():
    class Dev:
        def __init__(self, p):
            self.process_index = p

    for groups in ([], [0], [0, 0, 1, 1], [0, 1, 0, 1], [0, 0, 0, 0]):
        devs = [Dev(p) for p in groups]
        assert multihost.dcn_boundary_crossings(devs) == jmh.dcn_boundary_crossings(devs)
        assert multihost.dcn_boundary_crossings(groups) == jmh.dcn_boundary_crossings(devs)
    assert multihost.dcn_boundary_crossings(multihost.make_particle_mesh(8)) == 0
    for W in (2, 4):
        m = ParticleMesh(8, world_size=W, rank=0, distributed=True)
        assert multihost.dcn_boundary_crossings(m) == W
        assert multihost.dcn_boundary_crossings([p for p in range(W) for _ in range(8 // W)]) == W


@pytest.mark.parametrize("mode", ["all_particles", "all_scores", "partitions"])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_ring_hops_per_step_matches_jax(mode, S):
    assert exchange.ring_hops_per_step(mode, S) == jexchange.ring_hops_per_step(mode, S)


SINGLE_CASES = {
    "gather all_scores": dict(exchange_scores=True),
    "ring all_scores median_step": dict(exchange_impl="ring", kernel="median_step"),
    "lagged": dict(exchange_scores=False, exchange_every=2),
    "partitions": dict(exchange_particles=False, exchange_scores=False),
    "w2 global": dict(include_wasserstein=True, wasserstein_solver="sinkhorn",
                      sinkhorn_iters=20),
    "ring w2 block": dict(exchange_impl="ring", include_wasserstein=True,
                          wasserstein_solver="sinkhorn", w2_pairing="block",
                          sinkhorn_iters=20),
    "minibatch prior": dict(exchange_scores=False, batch_size=3, seed=5, shard_data=True,
                            log_prior=lambda th: -0.5 * (th * th).sum()),
}


def _lik(th, data):
    x, t = data
    return -torch.nn.functional.softplus(-t * (x[:, 0] * th[0] + th[1])).sum()


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_process_mesh_equals_meshless_bitwise(case):
    """A one-process ParticleMesh is the emulation bit for bit: particles,
    state and history; its particles come out as this process's rows (all
    of them, from row 0)."""
    kw = dict(SINGLE_CASES[case])
    rng = np.random.default_rng(1)
    parts = rng.normal(size=(N, D))
    kw.setdefault("include_wasserstein", False)
    kernel = kw.pop("kernel", None)
    if "batch_size" in kw:
        kw.update(data=(rng.normal(size=(48, 1)), np.where(rng.normal(size=48) > 0, 1., -1.)))
        logp = _lik
    else:
        logp = lambda th, _: gmm_logp(th)  # noqa: E731
    plain = tdt.DistSampler(8, logp, kernel, parts, device="cpu", **kw)
    meshed = tdt.DistSampler(8, logp, kernel, parts, device="cpu",
                             mesh=multihost.make_particle_mesh(8), **kw)
    want, hist = plain.run_steps(4, 0.05, record=True, h=0.5)
    got, ghist = meshed.run_steps(4, 0.05, record=True, h=0.5)
    assert isinstance(got, GlobalRows) and (got.start, got.n_global) == (0, N)
    assert torch.equal(got.rows, want) and torch.equal(ghist, hist)
    a, b = plain.state_dict(), meshed.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k] is None and b[k] is None) or np.array_equal(a[k], b[k]), k


def test_single_process_mesh_takes_global_rows_and_restores():
    rng = np.random.default_rng(2)
    parts = rng.normal(size=(N, D))
    mesh = multihost.make_particle_mesh(4)
    block = multihost.make_global_particles(parts, mesh)
    kw = dict(include_wasserstein=True, wasserstein_solver="sinkhorn", sinkhorn_iters=20,
              device="cpu")
    a = tdt.DistSampler(4, lambda th, _: gmm_logp(th), "median", block, mesh=mesh, **kw)
    b = tdt.DistSampler(4, lambda th, _: gmm_logp(th), "median", parts, **kw)
    assert a.kernel.bandwidth == b.kernel.bandwidth
    a.run_steps(3, 0.05)
    c = tdt.DistSampler(4, lambda th, _: gmm_logp(th), "median", parts, mesh=mesh, **kw)
    c.load_state_dict(a.state_dict())
    assert torch.equal(c.run_steps(2, 0.05).rows, a.run_steps(2, 0.05).rows)
    with pytest.raises(ValueError, match="mesh has 4 shards"):
        tdt.DistSampler(8, lambda th, _: gmm_logp(th), None, parts, mesh=mesh, **kw)


def test_multiprocess_mesh_refusals():
    """Under a mesh over several processes the Gauss–Seidel sweep,
    kernel_approx and the chunked run_steps raise naming ROADMAP A10 (no
    collective runs before the refusal); a block at another process's rows
    raises."""
    mesh = ParticleMesh(8, world_size=2, rank=1, device="cpu", backend="gloo",
                        distributed=True)
    parts = np.random.default_rng(3).normal(size=(N, D))
    gmm = lambda th, _: gmm_logp(th)  # noqa: E731
    base = dict(include_wasserstein=False, mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tdt.DistSampler(8, gmm, None, parts, update_rule="gauss_seidel", **base)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tdt.DistSampler(8, gmm, None, parts, kernel_approx="rff", **base)
    ds = tdt.DistSampler(8, gmm, None, parts, exchange_impl="ring", **base)
    assert ds.particles.start == 16 and torch.equal(ds.particles.rows,
                                                     torch.as_tensor(parts[16:]))
    for kw in ({"dispatch_budget": 1.0}, {"hops_per_dispatch": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            ds.run_steps(2, 0.1, **kw)
    with pytest.raises(ValueError, match="this process's shards own rows 16"):
        tdt.DistSampler(8, gmm, None, GlobalRows(torch.zeros(16, D), 0, N), **base)
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        exchange.make_shard_step(gmm, tdt.RBF(1.0), "all_scores", 8, 1.0,
                                 update_rule="gauss_seidel", mesh=mesh)


# ---- federations ------------------------------------------------------- #


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """One 2-process federation (4 shards each) running every leg."""
    out = tmp_path_factory.mktemp("mh2")
    run_federation(out, 2, "gather,ring,lagged,partitions,minibatch,w2,ring_w2_block,"
                           "partitions_w2_data")
    return out


def test_two_process_federation_matches_jax(two_process_run):
    """Two processes, 4 shards each, one gloo group: gather (all_scores),
    ring (all_scores), lagged (T = 2) and partitions against JAX's
    DistSampler on make_particle_mesh(8)."""
    tmp_path = two_process_run
    tol = dict(rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(assemble(tmp_path, 2, "gather"),
                               jax_run(8, 5, exchange_particles=True, exchange_scores=True),
                               **tol)
    np.testing.assert_allclose(assemble(tmp_path, 2, "ring"),
                               jax_run(8, 4, exchange_particles=True, exchange_scores=True,
                                       exchange_impl="ring"), **tol)
    np.testing.assert_allclose(assemble(tmp_path, 2, "lagged"),
                               jax_run(8, 4, exchange_particles=True, exchange_scores=False,
                                       exchange_every=2), **tol)
    np.testing.assert_allclose(assemble(tmp_path, 2, "partitions"),
                               jax_run(8, 4, exchange_particles=False, exchange_scores=False),
                               **tol)


def test_two_process_federation_minibatch_and_w2(two_process_run):
    """The legs JAX's workers do not run, across two processes: the
    minibatched all_particles step with shard_data and log_prior (float64),
    the Sinkhorn W2 term under the global pairing, and the ring with the
    block pairing and the per-step median bandwidth — against the port's
    one-process run: layout-free, bit for bit where no psum or gather
    reorders a sum, within JAX's 2e-6 / 2e-7 for the W2 step.  Partitions
    with data and the W2 term: each shard's data slice rotates by its
    global index, and the block pairing's roll crosses the processes."""
    tmp_path = two_process_run
    tol = dict(rtol=2e-6, atol=2e-7)
    rng = np.random.default_rng(3)
    data = (rng.normal(size=(48, 1)), np.where(rng.normal(size=48) > 0, 1.0, -1.0))
    mb = tdt.DistSampler(8, _lik, None, full_init().astype(np.float64), data=data,
                         exchange_scores=False, shard_data=True, batch_size=3, seed=7,
                         log_prior=lambda th: -0.5 * (th * th).sum(),
                         include_wasserstein=False, device="cpu")
    np.testing.assert_array_equal(assemble(tmp_path, 2, "minibatch"),
                                  mb.run_steps(4, 0.05).numpy())
    w2 = tdt.DistSampler(8, lambda th, _: gmm_logp(th), None, full_init(),
                         include_wasserstein=True, wasserstein_solver="sinkhorn",
                         sinkhorn_iters=50, device="cpu")
    np.testing.assert_allclose(assemble(tmp_path, 2, "w2"), w2.run_steps(4, 0.1, h=0.5).numpy(),
                               **tol)
    ring = tdt.DistSampler(8, lambda th, _: gmm_logp(th), "median_step", full_init(),
                           exchange_impl="ring", exchange_scores=False,
                           include_wasserstein=True, wasserstein_solver="sinkhorn",
                           sinkhorn_iters=30, w2_pairing="block", device="cpu")
    np.testing.assert_array_equal(assemble(tmp_path, 2, "ring_w2_block"),
                                  ring.run_steps(4, 0.1, h=0.5).numpy())
    part = tdt.DistSampler(8, _lik, None, full_init().astype(np.float64), data=data,
                           exchange_particles=False, exchange_scores=False,
                           include_wasserstein=True, wasserstein_solver="sinkhorn",
                           sinkhorn_iters=30, device="cpu")
    np.testing.assert_allclose(assemble(tmp_path, 2, "partitions_w2_data"),
                               part.run_steps(4, 0.05, h=0.5).numpy(), rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def four_process_run(tmp_path_factory):
    """One 4-process federation (2 shards each): gather, ring, lagged, the
    4-shard subset mesh (one shard a process), and the W2 run that saves
    each rank's block at t = 3 and goes on to t = 5 (a same-layout resume
    checked in the worker)."""
    out = tmp_path_factory.mktemp("mh4")
    run_federation(out, 4, "gather,ring,lagged,subset,ckpt")
    return out


def test_four_process_federation_matches_jax(four_process_run):
    out = four_process_run
    tol = dict(rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(assemble(out, 4, "gather"),
                               jax_run(8, 5, exchange_particles=True, exchange_scores=True),
                               **tol)
    np.testing.assert_allclose(assemble(out, 4, "ring"),
                               jax_run(8, 4, exchange_particles=True, exchange_scores=True,
                                       exchange_impl="ring"), **tol)
    np.testing.assert_allclose(assemble(out, 4, "lagged"),
                               jax_run(8, 4, exchange_particles=True, exchange_scores=False,
                                       exchange_every=2), **tol)
    np.testing.assert_allclose(assemble(out, 4, "subset"),
                               jax_run(4, 4, exchange_particles=True, exchange_scores=False),
                               **tol)


@pytest.fixture(scope="module")
def cross_restore_run(four_process_run, tmp_path_factory):
    """A 2-process federation resuming the 4-process one's per-rank saves."""
    out = tmp_path_factory.mktemp("mh2_restore")
    for p in four_process_run.glob("ckpt_rank*"):
        os.symlink(p, out / p.name)
    run_federation(out, 2, "ckpt_restore")
    return out


def test_cross_process_count_restore(four_process_run, cross_restore_run):
    """The W = 4 federation's per-rank W2 saves (snapshot stack and duals
    riding along) resume in a W = 2 federation through assemble_full_state;
    a lone foreign-layout block raises "matches neither" in the worker.  The
    resumed tail equals the uninterrupted W = 4 run at JAX's 1e-6 / 1e-7."""
    tmp_path = cross_restore_run
    want = assemble(four_process_run, 4, "ckpt_want")
    np.testing.assert_allclose(assemble(tmp_path, 2, "cross"), want, rtol=1e-6, atol=1e-7)
    blocks = [ckpt.load_state(str(p)) for p in sorted(four_process_run.glob("ckpt_rank*"))]
    man = ckpt.read_manifest(blocks[0])
    assert man["process_count"] == 4 and man["granule_shards"].tolist() == [2, 2, 2, 2]
    assert [int(b["previous_start"]) for b in blocks] == [0, 2, 4, 6]
