"""The port's checkpoints (``dist_svgd_torch/utils/checkpoint.py``) against
the JAX package's (``tests/test_checkpoint.py``), on the CPU.

Storage: npz round trips, retention, the corrupt-step fallback, the
orbax-marker ``ImportError``, ``TopologyMismatch`` before any tensor op.
Reshard: ``reshard_state`` / ``reshard_previous_stack`` /
``assemble_full_state`` against JAX's on the same numpy state, exactly;
the port sampler's reshard-on-restore against the snapshot definition
(exact).  Resume: a save at step k resumed in a fresh sampler is bitwise
the uninterrupted run.  Crossing: a JAX npz save resumes in the port, and a
port save in JAX, within 1e-10 (float64, the port's 'torch' φ against JAX's
'xla')."""

import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.gmm import gmm_logp as jgmm_logp
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.utils import checkpoint as jck

import dist_svgd_torch as tdt
from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.utils import checkpoint as tck
from dist_svgd_torch.utils.interop import state_from_jax

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: JAX against the port in float64 ('xla' against 'torch'): summation order
#: only (tests/test_torch_distsampler.py's tolerance).
RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _logreg(rng, d=4, n=8, rows=24):
    x = rng.normal(size=(rows, d - 1))
    t = np.where(rng.normal(size=rows) > 0, 1.0, -1.0)
    return rng.normal(size=(n, d)), x, t


def _port(parts, x, t, S=4, **kw):
    kw.setdefault("include_wasserstein", False)
    return tdt.DistSampler(S, logreg_logp, None, parts, data=(x, t), phi_impl="torch",
                           device="cpu", **kw)


def _jax(parts, x, t, S=4, **kw):
    kw.setdefault("include_wasserstein", False)
    return jdt.DistSampler(S, jlogreg_logp, None, jnp.asarray(parts),
                           data=(jnp.asarray(x), jnp.asarray(t)), phi_impl="xla", **kw)


def _w2(S, parts, **kw):
    return tdt.DistSampler(S, lambda th, _=None: gmm_logp(th), None, parts,
                           include_wasserstein=True, wasserstein_solver="sinkhorn",
                           sinkhorn_iters=20, phi_impl="torch", device="cpu", **kw)


def _jw2(S, parts, **kw):
    return jdt.DistSampler(S, lambda th, _=None: jgmm_logp(th), None, jnp.asarray(parts),
                           include_wasserstein=True, wasserstein_solver="sinkhorn",
                           sinkhorn_iters=20, phi_impl="xla", **kw)


# --------------------------------------------------------------------------
# Storage


def test_save_load_roundtrip_elides_none_and_takes_tensors(tmp_path, rng):
    parts = rng.normal(size=(8, 3))
    state = {"particles": torch.from_numpy(parts), "t": np.int64(7), "previous": None,
             "w2_g": torch.zeros(2, 4, dtype=torch.float32)}
    path = tck.save_state(str(tmp_path / "ck"), state)
    assert os.listdir(path) == ["state.npz"]  # JAX's npz layout and file name
    got = tck.load_state(path)
    assert "previous" not in got and int(got["t"]) == 7
    np.testing.assert_array_equal(got["particles"], parts)
    assert got["w2_g"].dtype == np.float32


def test_save_overwrites_and_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "ck")
    tck.save_state(path, {"a": np.zeros(2)})
    tck.save_state(path, {"a": np.ones(3)})
    np.testing.assert_array_equal(tck.load_state(path)["a"], np.ones(3))
    assert not os.path.exists(path + ".tmp")


def test_save_crash_leaves_previous_checkpoint_intact(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    tck.save_state(path, {"a": np.zeros(2)})

    def boom(*a, **k):
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError):
        tck.save_state(path, {"a": np.ones(2)})
    np.testing.assert_array_equal(tck.load_state(path)["a"], np.zeros(2))


@pytest.mark.parametrize("backend", ["auto", "npz"])
def test_jax_npz_save_loads_in_the_port_and_back(tmp_path, rng, backend):
    """The two packages' npz layouts are one: each loads the other's files
    (the port's 'auto' is the npz layout)."""
    state = {"particles": rng.normal(size=(6, 2)), "t": np.int64(3)}
    jpath = jck.save_state(str(tmp_path / "j"), state, backend="npz")
    ppath = tck.save_state(str(tmp_path / "p"), state, backend=backend)
    for got in (tck.load_state(jpath), jck.load_state(ppath)):
        np.testing.assert_array_equal(got["particles"], state["particles"])
        assert int(got["t"]) == 3
    with pytest.raises(ValueError, match="backend"):
        tck.save_state(str(tmp_path / "x"), state, backend="orbax")


def test_manager_cadence_retention_latest(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "root"), every=5, max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest() is None
    assert mgr.restore_latest(with_step=True) == (None, None)
    assert [s for s in range(1, 16) if mgr.should_save(s)] == [5, 10, 15]
    assert not mgr.should_save(0)
    for step in (5, 10, 15):
        mgr.save(step, {"t": np.int64(step)})
    assert sorted(os.listdir(mgr.root)) == ["step_10", "step_15"]
    assert mgr.latest_step() == 15
    step, state = mgr.restore_latest(with_step=True)
    assert step == 15 and int(state["t"]) == 15


@pytest.mark.parametrize("corruption", ["empty", "truncated", "stray"])
def test_restore_latest_skips_corrupt_checkpoint(tmp_path, corruption):
    mgr = tck.CheckpointManager(str(tmp_path / "root"), every=1, max_to_keep=5)
    mgr.save(1, {"t": np.int64(1)})
    bad = os.path.join(mgr.root, "step_2")
    os.makedirs(bad)
    if corruption == "truncated":
        with open(os.path.join(bad, "state.npz"), "wb") as f:
            f.write(b"PK\x03\x04 not a zip")
    elif corruption == "stray":
        with open(os.path.join(bad, "junk.bin"), "wb") as f:
            f.write(b"x")
    with pytest.warns(UserWarning, match="skipping unloadable"):
        step, state = mgr.restore_latest(with_step=True)
    assert step == 1 and int(state["t"]) == 1


def test_orbax_layout_raises_importerror_and_propagates(tmp_path):
    """An orbax-layout directory is the environment, not corruption: the
    loader raises ImportError and restore_latest does not skip it."""
    mgr = tck.CheckpointManager(str(tmp_path / "root"), every=1)
    mgr.save(1, {"t": np.int64(1)})
    orbax = os.path.join(mgr.root, "step_2")
    os.makedirs(orbax)
    open(os.path.join(orbax, "_METADATA"), "w").close()
    with pytest.raises(ImportError, match="orbax"):
        tck.load_state(orbax)
    with pytest.raises(ImportError):
        mgr.restore_latest()


def test_load_state_diagnoses_missing_and_empty(tmp_path):
    with pytest.raises(FileNotFoundError):
        tck.load_state(str(tmp_path / "nope"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="neither layout"):
        tck.load_state(str(tmp_path / "empty"))


def test_manager_rejects_bad_arguments_and_clears(tmp_path):
    with pytest.raises(ValueError, match="positive"):
        tck.CheckpointManager(str(tmp_path / "r"), every=0)
    with pytest.raises(ValueError, match="backend"):
        tck.CheckpointManager(str(tmp_path / "r"), backend="orbax")
    mgr = tck.CheckpointManager(str(tmp_path / "r"), every=1)
    for s in (1, 2):
        mgr.save(s, {"t": np.int64(s)})
    mgr.clear()
    assert mgr.latest_step() is None


def test_expect_topology_raises_before_any_tensor_op(tmp_path, rng):
    parts, x, t = _logreg(rng)
    path = tck.save_state(str(tmp_path / "ck"), _port(parts, x, t).state_dict())
    assert tck.load_state(path, expect_topology={"n_particles": 8, "d": 4})
    for expect in ({"n_particles": 16}, {"d": 5}, {"n_shards": 2}):
        with pytest.raises(tck.TopologyMismatch, match="reshard_state"):
            tck.load_state(path, expect_topology=expect)
    wrong_n = _port(rng.normal(size=(12, 4)), x, t)
    with pytest.raises(tck.TopologyMismatch):
        wrong_n.load_state_dict(tck.load_state(path))


def test_topology_manifest_matches_jax_and_process_stamp():
    for kw in (dict(), dict(process_count=4), dict(process_count=2, granule_shards=[6, 2])):
        ours, theirs = tck.topology_manifest(8, 64, 2, 5, **kw), jck.topology_manifest(
            8, 64, 2, 5, **kw)
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
        assert tck.read_manifest(dict(ours))["granule_shards"].tolist() == \
            jck.read_manifest(dict(theirs))["granule_shards"].tolist()
    with pytest.raises(ValueError, match="granule"):
        tck.topology_manifest(8, 64, 2, process_count=2, granule_shards=[6, 3])
    with pytest.raises(ValueError, match="divide"):
        tck.topology_manifest(8, 64, 2, process_count=3)
    bad = dict(tck.topology_manifest(8, 64, 2, process_count=4))
    bad["topo_granule_shards"] = np.asarray([2, 2, 2, 3], dtype=np.int64)
    assert tck.read_manifest(bad) is None


# --------------------------------------------------------------------------
# Reshard against JAX's, on the same numpy state


def _saved_w2_state(rng, S, exchanged, n=16, d=3):
    """A JAX W2 run's state_dict (3 make_steps), as numpy."""
    parts = rng.normal(size=(n, d))
    js = _jw2(S, parts, exchange_particles=exchanged, exchange_scores=False)
    for _ in range(3):
        js.make_step(0.05, h=0.5)
    return {k: (None if v is None else np.asarray(v)) for k, v in js.state_dict().items()}


@pytest.mark.parametrize("to", [1, 2, 4, 8, 3])
@pytest.mark.parametrize("exchanged", [True, False], ids=["mixed", "block"])
def test_reshard_state_matches_jax(rng, exchanged, to):
    state = _saved_w2_state(rng, 8, exchanged)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # to = 3 does not divide 16: both warn
        ours, theirs = tck.reshard_state(state, to), jck.reshard_state(state, to)
    assert ours.keys() == theirs.keys()
    for k in ours:
        if ours[k] is None:
            assert theirs[k] is None
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]))


@pytest.mark.parametrize("want", [(4, 16, 3), (1, 16, 3), (4, 4, 3), (2, 8, 3)])
def test_reshard_previous_stack_matches_jax(rng, want):
    prev = _saved_w2_state(rng, 8, True)["previous"]
    np.testing.assert_array_equal(tck.reshard_previous_stack(prev, 16, 3, want),
                                  jck.reshard_previous_stack(prev, 16, 3, want))


def test_reshard_state_refusals_match_jax(rng):
    block = _saved_w2_state(rng, 8, False)["previous"]
    for mod in (tck, jck):
        with pytest.raises(ValueError, match="cannot reshard"):
            mod.reshard_previous_stack(block, 16, 3, (4, 16, 3))
        with pytest.raises(ValueError, match="neither a mixed"):
            mod.reshard_previous_stack(np.zeros((3, 5, 3)), 16, 3, (4, 16, 3))
        with pytest.raises(ValueError, match="FULL global"):
            mod.reshard_state({"particles": np.zeros((4, 2)), "particles_start": 4}, 2)
        with pytest.raises(ValueError, match=">= 1"):
            mod.reshard_state({"particles": np.zeros((4, 2))}, 0)


def test_assemble_full_state_matches_jax(tmp_path):
    def save(name, start, t, fill, extra=None):
        st = {"particles": np.full((4, 2), fill, dtype=np.float32),
              "particles_start": np.int64(start), "t": np.int64(t),
              **tck.topology_manifest(4, 8, 2, process_count=2)}
        st.update(extra or {})
        return tck.save_state(str(tmp_path / name), st)

    a, b = save("a", 0, 3, 1.0), save("b", 4, 3, 2.0)
    ours, theirs = tck.assemble_full_state([b, a]), jck.assemble_full_state([b, a])
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert int(ours["topo_process_count"]) == 1
    with pytest.raises(tck.TopologyMismatch):
        tck.assemble_full_state([a, b], expect_topology={"n_particles": 16})
    for bad, match in (([a, save("c", 4, 5, 2.0)], "disagree"),
                       ([a, save("e", 8, 3, 2.0)], "contiguous"),
                       ([a, save("f", 4, 3, 2.0, {"x": np.float64(7.0)})],
                        "complete multi-host save")):
        for mod in (tck, jck):
            with pytest.raises(ValueError, match=match):
                mod.assemble_full_state(bad)
    with pytest.raises(ValueError, match="at least one"):
        tck.assemble_full_state([])


# --------------------------------------------------------------------------
# The sampler: resume and reshard-on-restore


@pytest.mark.parametrize("mode", [dict(exchange_particles=True, exchange_scores=True),
                                  dict(exchange_particles=False, exchange_scores=False)],
                         ids=["all_scores", "partitions"])
def test_resume_reproduces_trajectory_bitwise(tmp_path, rng, mode):
    parts, x, t = _logreg(rng)
    ref = _port(parts, x, t, batch_size=3, **mode)
    want = ref.run_steps(6, 1e-2)
    a = _port(parts, x, t, batch_size=3, **mode)
    a.run_steps(3, 1e-2)
    path = tck.save_state(str(tmp_path / "mid"), a.state_dict())
    b = _port(np.zeros_like(parts), x, t, batch_size=3, seed=99, **mode)
    b.load_state_dict(tck.load_state(path))
    torch.testing.assert_close(b.run_steps(3, 1e-2), want, rtol=0, atol=0)


@pytest.mark.parametrize("pairing", ["global", "block"])
def test_resume_with_wasserstein_state_bitwise(tmp_path, rng, pairing):
    parts = rng.normal(size=(8, 3))
    kw = dict(exchange_particles=True, exchange_scores=False, w2_pairing=pairing)
    ref = _w2(4, parts, **kw)
    want = ref.run_steps(4, 1e-2, h=0.5)
    a = _w2(4, parts, **kw)
    a.run_steps(2, 1e-2, h=0.5)
    mgr = tck.CheckpointManager(str(tmp_path / "r"), every=2)
    mgr.save(2, a.state_dict())
    b = _w2(4, np.zeros_like(parts), **kw)
    b.load_state_dict(mgr.restore_latest())
    assert b._previous is not None and b._w2_g is not None
    torch.testing.assert_close(b.run_steps(2, 1e-2, h=0.5), want, rtol=0, atol=0)


def test_resharded_restore_exchanged_matches_the_snapshot_definition(rng):
    """Save at 8 shards, restore at 4: the particles verbatim, the mixed
    stack rebuilt exactly (pre-update global with the own block
    post-update), the dual dropped; 8 → 1 is the post-update global."""
    n, d = 16, 3
    parts = rng.normal(size=(n, d))
    kw = dict(exchange_particles=True, exchange_scores=False)
    a = _w2(8, parts, **kw)
    for _ in range(3):
        pre = a.particles.clone().numpy()
        a.make_step(0.05, h=0.5)
    post = a.particles.numpy()
    state = a.state_dict()
    b = _w2(4, parts, **kw)
    b.load_state_dict(state)
    np.testing.assert_array_equal(b.particles.numpy(), post)
    want = np.broadcast_to(pre, (4, n, d)).copy()
    for r in range(4):
        want[r, r * 4:(r + 1) * 4] = post[r * 4:(r + 1) * 4]
    np.testing.assert_array_equal(b._previous.numpy(), want)
    assert b._w2_g is None
    assert torch.isfinite(b.run_steps(2, 0.05, h=0.5)).all()
    c = _w2(1, parts, **kw)
    c.load_state_dict(state)
    np.testing.assert_array_equal(c._previous.numpy(), post[None])


def test_resharded_restore_matches_jax_resharded_resume(rng):
    """An 8-shard save resumed at 4 shards in both packages: the same
    resharded state, and the same trajectory after it (the dual restarts
    cold in both)."""
    n, d = 16, 3
    parts = rng.normal(size=(n, d))
    kw = dict(exchange_particles=True, exchange_scores=False)
    js = _jw2(8, parts, **kw)
    for _ in range(3):
        js.make_step(0.05, h=0.5)
    jstate = {k: (None if v is None else np.asarray(v)) for k, v in js.state_dict().items()}
    j4 = _jw2(4, parts, **kw)
    j4.load_state_dict(jstate)
    p4 = _w2(4, parts, **kw)
    p4.load_state_dict(state_from_jax(jstate, "cpu"))
    np.testing.assert_array_equal(p4._previous.numpy(), np.asarray(j4._previous))
    assert p4._w2_g is None and j4._w2_g is None
    for _ in range(2):
        np.testing.assert_allclose(p4.make_step(0.05, h=0.5).numpy(),
                                   np.asarray(j4.make_step(0.05, h=0.5)),
                                   rtol=RTOL, atol=ATOL)


def test_resharded_restore_partitions_and_impossible_cases(rng):
    n, d = 16, 2
    parts = rng.normal(size=(n, d))
    part = dict(exchange_particles=False, exchange_scores=False)
    a = _w2(8, parts, **part)
    for _ in range(3):
        a.make_step(0.05, h=0.5)
    b = _w2(4, parts, **part)
    b.load_state_dict(a.state_dict())
    np.testing.assert_array_equal(b._previous.numpy(), a.particles.numpy().reshape(4, 4, d))
    ex = _w2(4, parts, exchange_particles=True, exchange_scores=False)
    with pytest.raises(ValueError, match="cannot reshard"):
        ex.load_state_dict(a.state_dict())
    with pytest.raises(ValueError, match="neither a mixed"):
        ex.load_state_dict({"particles": parts, "t": 1, "previous": np.zeros((3, 5, d))})


# --------------------------------------------------------------------------
# Crossing between the packages


def test_jax_save_resumes_in_the_port(tmp_path, rng):
    """JAX saves at step 3 (npz); the port loads the file, converts it
    (state_from_jax) and continues: the same trajectory as JAX's
    uninterrupted run."""
    parts, x, t = _logreg(rng)
    ref = _jax(parts, x, t)
    for _ in range(6):
        want = ref.make_step(1e-2)
    js = _jax(parts, x, t)
    for _ in range(3):
        js.make_step(1e-2)
    path = jck.save_state(str(tmp_path / "j"), js.state_dict(), backend="npz")
    ps = _port(np.zeros_like(parts), x, t)
    ps.load_state_dict(state_from_jax(tck.load_state(path), "cpu", sampler=ps))
    assert ps.t == 3
    np.testing.assert_allclose(ps.run_steps(3, 1e-2).numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_jax_w2_save_resumes_in_the_port(tmp_path, rng):
    parts = rng.normal(size=(8, 3))
    kw = dict(exchange_particles=True, exchange_scores=False)
    ref = _jw2(4, parts, **kw)
    for _ in range(4):
        want = ref.make_step(1e-2, h=0.5)
    js = _jw2(4, parts, **kw)
    for _ in range(2):
        js.make_step(1e-2, h=0.5)
    path = jck.save_state(str(tmp_path / "j"), js.state_dict(), backend="npz")
    ps = _w2(4, np.zeros_like(parts), **kw)
    ps.load_state_dict(state_from_jax(tck.load_state(path), "cpu"))
    for _ in range(2):
        got = ps.make_step(1e-2, h=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


def test_port_save_resumes_in_jax(tmp_path, rng):
    """The port saves at step 3; JAX's load_state + load_state_dict take it
    and continue the port's trajectory.  JAX ignores the port's
    rng_batch_seed (an unknown key) and, missing rng_batch_key, keeps its
    own constructed key."""
    parts, x, t = _logreg(rng)
    ref = _port(parts, x, t)
    want = ref.run_steps(6, 1e-2)
    ps = _port(parts, x, t)
    ps.run_steps(3, 1e-2)
    path = tck.save_state(str(tmp_path / "p"), ps.state_dict())
    saved = jck.load_state(path)
    assert "rng_batch_seed" in saved and "rng_batch_key" not in saved
    js = _jax(np.zeros_like(parts), x, t)
    key0 = np.asarray(js._batch_key)
    js.load_state_dict(saved)
    np.testing.assert_array_equal(np.asarray(js._batch_key), key0)
    assert js.t == 3
    for _ in range(3):
        got = js.make_step(1e-2)
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=RTOL, atol=ATOL)


def test_port_w2_save_resumes_in_jax(tmp_path, rng):
    parts = rng.normal(size=(8, 3))
    kw = dict(exchange_particles=True, exchange_scores=False)
    ref = _w2(4, parts, **kw)
    for _ in range(4):
        want = ref.make_step(1e-2, h=0.5)
    ps = _w2(4, parts, **kw)
    for _ in range(2):
        ps.make_step(1e-2, h=0.5)
    path = tck.save_state(str(tmp_path / "p"), ps.state_dict())
    js = _jw2(4, np.zeros_like(parts), **kw)
    js.load_state_dict(jck.load_state(path))
    assert js._previous is not None and js._w2_g is not None
    for _ in range(2):
        got = js.make_step(1e-2, h=0.5)
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=1e-8, atol=1e-10)
    assert jax.config.read("jax_enable_x64")
