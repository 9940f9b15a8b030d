"""The mesh half of the port's ``Plan`` (``dist_svgd_torch/parallel/plan.py``)
and the engine's sharded bucket programs, against JAX's
(``dist_svgd_tpu/parallel/plan.py``, ``serving/engine.py``) case for case
with the mesh cases of ``tests/test_plan.py``, on the CPU.

The port's mesh is 8 × ``cpu`` (a device may repeat: the port's form of
XLA's forced host device count); JAX's is ``make_plan(8)`` over the
conftest's 8 virtual CPU devices.  The same numpy ensembles and requests go
through both sharded engines and the port's single-device engine, at
``tests/test_plan.py``'s tolerances (logreg ``rtol=1e-5, atol=1e-7``; bnn
and gmm ``atol=1e-6``); the bf16 tier within one bf16 ulp of the
single-device bf16 engine.  The card path (one CUDA graph per physical
device and shape) runs in ``chip_smoke.py`` section 28; here its two
captured functions are composed eagerly over a mesh of two distinct CPU
device names, the arithmetic of the several-card branch."""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_svgd_torch.parallel import plan as tplan
from dist_svgd_torch.parallel.plan import (
    AXIS,
    Mesh,
    MeshProgram,
    Plan,
    ShardedEnsemble,
    capture_sentry,
    ensemble_tensor,
    make_plan,
    nondividing_replicate_warning,
)
from dist_svgd_torch.serving import MicroBatcher, PredictionServer, PredictiveEngine

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: logreg outputs: JAX's pins (``tests/test_plan.py``).
LOGREG_TOL = dict(rtol=1e-5, atol=1e-7)
#: bnn and gmm outputs.
OTHER_TOL = dict(rtol=1e-5, atol=1e-6)
#: One bf16 ulp relative to the value (2^-7 of the leading power of two).
BF16_ULP = 2.0 ** -7


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.fixture
def plan8():
    plan = make_plan(8, devices=["cpu"] * 8)
    assert plan.is_sharded and plan.num_shards == 8
    return plan


@pytest.fixture(scope="module")
def jplan8():
    from dist_svgd_tpu.parallel.plan import make_plan as jmake_plan

    plan = jmake_plan(8)
    assert plan.is_sharded, "conftest guarantees 8 virtual CPU devices"
    return plan


def _within_ulps(got, want, ulps=1):
    """``|got − want|`` within ``ulps`` bf16 ulps of ``max(|got|, |want|)``."""
    scale = np.exp2(np.floor(np.log2(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                                1e-30))))
    return bool(np.all(np.abs(got - want) <= ulps * BF16_ULP * scale))


# --------------------------------------------------------------------- #
# Plan: construction, placement, compile


def test_mesh_plan_identity_and_make_plan(monkeypatch, jplan8):
    mesh = Mesh(["cpu"] * 8)
    assert mesh.axis_names == (AXIS,) and mesh.shape == {AXIS: 8}
    assert mesh.devices == (torch.device("cpu"),) * 8
    plan = Plan(mesh)
    assert plan.num_shards == 8 and plan.is_sharded and plan.mesh is mesh
    assert plan.device == torch.device("cpu") and "num_shards=8" in repr(plan)
    desc, jdesc = plan.describe(), jplan8.describe()
    assert desc.keys() == jdesc.keys()
    assert (desc["sharded"], desc["num_shards"]) == (jdesc["sharded"], jdesc["num_shards"])
    assert desc["devices"] == ["cpu"] * 8 and len(jdesc["devices"]) == 8
    # an explicit devices= list builds the mesh as given; fewer than asked degrade
    assert make_plan(4, devices=["cpu"] * 8).num_shards == 4
    solo = make_plan(9, devices=["cpu"] * 8)
    assert not solo.is_sharded and solo.device == torch.device("cpu")
    assert make_plan(None, devices=["cpu"] * 3).num_shards == 3
    # devices=None: the one cpu repeated visible_devices("cpu") times
    monkeypatch.setattr(tplan, "visible_devices", lambda device: 8)
    assert make_plan(device="cpu").num_shards == 8
    assert make_plan(2, device="cpu").mesh.devices == (torch.device("cpu"),) * 2
    assert make_plan(1, device="cpu").describe() == {"sharded": False, "num_shards": 1,
                                                     "devices": None}
    with pytest.raises(ValueError, match="num_shards"):
        make_plan(0, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "meta"])


def test_plan_rejects_foreign_axis():
    with pytest.raises(ValueError, match=AXIS):
        Plan(Mesh(["cpu"] * 2, ("replicas",)))
    with pytest.raises(ValueError, match="1-D"):
        Mesh(["cpu"] * 2, (AXIS, "other"))


def test_shardings_match_jaxs_specs(plan8, jplan8):
    assert plan8.replicated().spec == tuple(jplan8.replicated().spec) == ()
    for ndim in (1, 2, 3):
        assert plan8.particle_sharding(ndim).spec == tuple(jplan8.particle_sharding(ndim).spec)
    for spec in (None, 0, 1):
        assert plan8.spec_sharding(spec).spec == tuple(jplan8.spec_sharding(spec).spec)
    solo = Plan(device="cpu")
    assert solo.replicated() is solo.particle_sharding() is solo.spec_sharding(0) is None


def test_shard_ensemble_placement(plan8, jplan8, rng):
    parts = rng.normal(size=(64, 3)).astype(np.float32)
    placed = plan8.shard_ensemble(parts)
    jplaced = jplan8.shard_ensemble(parts)
    assert isinstance(placed, ShardedEnsemble)
    assert placed.spec == tuple(jplaced.sharding.spec) == (AXIS, None)
    assert placed.shape == (64, 3) and placed.dtype == torch.float32 and placed.dim() == 2
    assert len(placed.blocks) == 8
    for i, block in enumerate(placed.blocks):
        assert block.shape == (8, 3) and block.is_contiguous()
        np.testing.assert_array_equal(block.numpy(), parts[8 * i:8 * (i + 1)])
    np.testing.assert_array_equal(placed.numpy(), np.asarray(jplaced))
    np.testing.assert_array_equal(np.asarray(placed), parts)
    np.testing.assert_array_equal(ensemble_tensor(placed).numpy(), parts)
    assert ensemble_tensor(placed.blocks[0]) is placed.blocks[0]
    # the dispatch input lands on the mesh's first device
    assert plan8.replicate(parts[:2]).device == torch.device("cpu")
    assert plan8.replicate(3) == 3


def test_shard_ensemble_uneven_replicates_with_warning(plan8, jplan8, rng):
    parts = rng.normal(size=(10, 3)).astype(np.float32)  # 10 % 8 != 0
    with pytest.warns(UserWarning) as ours:
        placed = plan8.shard_ensemble(parts)
    with pytest.warns(UserWarning) as theirs:
        jplaced = jplan8.shard_ensemble(parts)
    assert str(ours[0].message) == str(theirs[0].message) == nondividing_replicate_warning(10, 8)
    assert placed.spec == tuple(jplaced.sharding.spec) == ()
    assert not placed.is_sharded and len(placed.blocks) == 8
    np.testing.assert_array_equal(placed.numpy(), parts)
    with pytest.raises(ValueError, match="particle axis"):
        plan8.shard_ensemble(np.float32(1.0))


def test_replicate_warning_one_text_at_both_sites():
    """The plan and ``utils/checkpoint.py:reshard_state`` warn with the one
    text ``nondividing_replicate_warning`` makes, as JAX's do."""
    from dist_svgd_tpu.parallel.plan import nondividing_replicate_warning as jwarning
    from dist_svgd_torch.utils.checkpoint import reshard_state

    state = {"particles": np.zeros((10, 2), np.float32), "t": 3}
    with pytest.warns(UserWarning) as from_ckpt:
        out = reshard_state(state, 4)
    with pytest.warns(UserWarning) as from_plan:
        Plan(Mesh(["cpu"] * 4)).shard_ensemble(state["particles"])
    texts = {str(w.message) for w in from_ckpt} & {str(w.message) for w in from_plan}
    assert texts == {nondividing_replicate_warning(10, 4)} == {jwarning(10, 4)}
    assert out["particles"].shape == (10, 2)


def _moments(parts):
    """A partial and a combine of an ensemble reduction (mean and biased
    variance of ``x @ pᵀ`` over the particles), and the one function."""

    def partial(block, x):
        v = (x @ block.T).T  # (n_i, b)
        m = v.mean(0)
        return m, ((v - m) ** 2).sum(0), torch.full_like(m, v.shape[0])

    def combine(parts):
        counts = torch.stack([p[2] for p in parts])
        means = torch.stack([p[0] for p in parts])
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        m2 = torch.stack([p[1] for p in parts]).sum(0) + (counts * (means - mean) ** 2).sum(0)
        return {"m": mean, "v": m2 / n}

    def whole(p):
        def fn(x):
            return {"m": torch.mean(x @ p.T, dim=1), "v": torch.var(x @ p.T, dim=1, correction=0)}
        return fn

    return partial, combine, whole


def test_plan_compile_matches_single_device_and_jax(plan8, jplan8, rng):
    """A closed-over ensemble reduction as a mesh program returns what the
    single-device program and JAX's 8-way compile return."""
    parts = rng.normal(size=(32, 4)).astype(np.float32)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    partial, combine, whole = _moments(parts)
    ens = plan8.shard_ensemble(parts)
    prog = plan8.compile(partial, combine=combine, ensemble=ens, label="t.mesh")
    assert isinstance(prog, MeshProgram) and prog.program_entry.num_shards == 8
    got = prog(plan8.replicate(torch.from_numpy(x)))
    want = Plan(device="cpu").compile(whole(torch.from_numpy(parts)))(torch.from_numpy(x))
    jparts = jplan8.shard_ensemble(parts)
    jgot = jplan8.compile(lambda xx: {"m": jnp.mean(xx @ jparts.T, axis=1),
                                      "v": jnp.var(xx @ jparts.T, axis=1)})(
        jplan8.replicate(jnp.asarray(x)))
    for k in ("m", "v"):
        assert got[k].device == torch.device("cpu")
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **LOGREG_TOL)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jgot[k]), **LOGREG_TOL)
    # without combine= a mesh plan compiles the one function on its first device
    repl = plan8.compile(whole(torch.from_numpy(parts)), label="t.repl")
    assert not isinstance(repl, MeshProgram) and repl.program_entry.num_shards == 8
    np.testing.assert_array_equal(repl(torch.from_numpy(x))["m"].numpy(), want["m"].numpy())
    with pytest.raises(ValueError, match="mesh"):
        Plan(device="cpu").compile(partial, combine=combine, ensemble=ens)
    with pytest.raises(ValueError, match="ensemble"):
        plan8.compile(partial, combine=combine)
    with pytest.raises(ValueError, match="combine"):
        plan8.compile(partial, ensemble=ens)


def test_mesh_program_tracks_like_a_program(plan8, rng):
    """One signature a new input shape, counted once; the entry records the
    mesh's shard count; ``audit_target`` is the eager call."""
    parts = rng.normal(size=(16, 3)).astype(np.float32)
    partial, combine, _ = _moments(parts)
    with tplan.use_registry() as reg:
        prog = plan8.compile(partial, combine=combine, ensemble=plan8.shard_ensemble(parts),
                             label="t.mesh", donate_argnums=(0,))
        (entry,) = reg.entries(label_prefix="t.mesh")
        assert entry is prog.program_entry
        assert (entry.kind, entry.num_shards, entry.donate_argnums) == ("compile", 8, (0,))
        with capture_sentry() as sentry:
            for rows in (3, 3, 5):
                prog(torch.ones(rows, 3))
        assert sentry.captures == 2 and entry.calls == 3 and prog.graphs == 0
        assert entry.shapes == [(((3, 3), torch.float32),), (((5, 3), torch.float32),)]
        x = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
        direct = prog.audit_target(x)
        np.testing.assert_array_equal(direct["v"].numpy(), prog(x)["v"].numpy())


def test_several_card_composition_matches_eager(rng):
    """The card path's two captured functions — each other device's shard
    partials, and the first device's partials plus the combine over the
    others' copied partials — composed eagerly over an interleaved mesh of
    two distinct device names give the eager mesh program's outputs."""
    parts = rng.normal(size=(24, 3)).astype(np.float32)
    plan = Plan(Mesh(["cpu", "cpu:0", "cpu", "cpu:0", "cpu", "cpu:0"]))
    partial, combine, _ = _moments(parts)
    prog = plan.compile(partial, combine=combine, ensemble=plan.shard_ensemble(parts))
    assert [idx for _, idx in prog._groups] == [[0, 2, 4], [1, 3, 5]]
    x = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    recv = [t for _, idx in prog._groups[1:] for part in prog._group_fn(idx)(x) for t in part]
    composed = prog._first_fn(1)(x, *recv)
    eager = prog(x)
    for k in ("m", "v"):
        np.testing.assert_array_equal(composed[k].numpy(), eager[k].numpy())


def test_compile_sharded_with_a_mesh_raises(plan8):
    with pytest.raises(ValueError, match="ParticleMesh"):
        plan8.compile_sharded(lambda x: x, in_specs=(0,), out_specs=(0,))
    assert Plan(device="cpu").compile_sharded(lambda x: x).program_entry.kind == "compile_sharded"


# --------------------------------------------------------------------- #
# engine: sharded ≡ JAX's sharded ≡ single-device


def _model_case(model, rng):
    """(particles, engine kwargs, request width) of ``tests/test_plan.py``'s
    three cases."""
    if model == "logreg":
        return rng.normal(size=(64, 5)).astype(np.float32), {}, 4
    if model == "bnn":
        from dist_svgd_torch.models.bnn import num_params

        return (rng.normal(size=(64, num_params(3, 4))).astype(np.float32),
                dict(n_features=3, n_hidden=4, y_mean=1.5, y_std=2.0), 3)
    return rng.normal(size=(64, 3)).astype(np.float32), dict(kde_bandwidth=0.8), 3


@pytest.mark.parametrize("bucket_rows", [1, 3, 7, 16])
@pytest.mark.parametrize("model", ["logreg", "bnn", "gmm"])
def test_sharded_engine_matches_jax_and_single(model, bucket_rows, plan8, jplan8, rng):
    from dist_svgd_tpu.serving import PredictiveEngine as JEngine

    parts, kw, width = _model_case(model, rng)
    single = PredictiveEngine(model, parts, min_bucket=4, max_bucket=16, device="cpu", **kw)
    sharded = PredictiveEngine(model, parts, min_bucket=4, max_bucket=16, plan=plan8, **kw)
    jsharded = JEngine(model, parts, min_bucket=4, max_bucket=16, plan=jplan8, **kw)
    assert sharded.stats()["plan"]["sharded"] is True
    assert sharded.particles.spec == tuple(jsharded.particles.sharding.spec) == (AXIS, None)
    x = rng.normal(size=(bucket_rows, width)).astype(np.float32)
    s, a, j = sharded.predict(x), single.predict(x), jsharded.predict(x)
    tol = LOGREG_TOL if model == "logreg" else OTHER_TOL
    for k in a:
        assert s[k].shape == (bucket_rows,) and s[k].dtype == np.float32
        np.testing.assert_allclose(s[k], a[k], **tol)
        np.testing.assert_allclose(s[k], np.asarray(j[k]), **tol)


@pytest.mark.parametrize("model", ["logreg", "bnn", "gmm"])
def test_bf16_sharded_composes(model, plan8, rng):
    """bf16 composed with sharding: the ensemble stays bf16 and sharded, the
    wire f32, and logreg's outputs within one bf16 ulp of the single-device
    bf16 engine (the f32 partials and combine cast once, as ``mean`` /
    ``var`` of one device do)."""
    parts, kw, width = _model_case(model, rng)
    eng = PredictiveEngine(model, parts, min_bucket=4, max_bucket=16, plan=plan8,
                           dtype=torch.bfloat16, **kw)
    single = PredictiveEngine(model, parts, min_bucket=4, max_bucket=16, device="cpu",
                              dtype=torch.bfloat16, **kw)
    assert eng.particles.spec == (AXIS, None) and eng.particles.dtype == torch.bfloat16
    assert eng.stats()["dtype"] == "bfloat16"
    assert eng._kernel_for(4)[0].program_entry.meta == {"pinned_f32": False}
    for b in (1, 3, 7, 16):
        x = rng.normal(size=(b, width)).astype(np.float32)
        out, ref = eng.predict(x), single.predict(x)
        for k in ref:
            assert out[k].dtype == np.float32 and out[k].shape == (b,)
            if model == "logreg":
                assert _within_ulps(out[k], ref[k]), (k, out[k], ref[k])
            else:
                assert _within_ulps(out[k], ref[k], ulps=2), (k, out[k], ref[k])


def test_sharded_engine_steady_state_no_captures(plan8, rng):
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16, plan=plan8)
    eng.warmup()
    misses = eng.stats()["bucket_misses"]
    with capture_sentry("sharded steady state") as sentry:
        for b in (1, 2, 5, 9, 16, 3, 11):
            eng.predict(rng.normal(size=(b, 4)).astype(np.float32))
    assert eng.stats()["bucket_misses"] == misses
    assert sentry.compiles == 0


def test_engine_mesh_shorthand_and_arg_conflict(plan8, rng):
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=8, mesh=plan8.mesh)
    assert eng.stats()["plan"]["num_shards"] == 8 and eng.device == torch.device("cpu")
    assert eng.particles.spec == (AXIS, None)
    with pytest.raises(ValueError, match="not both"):
        PredictiveEngine("logreg", parts, plan=plan8, mesh=plan8.mesh)


# --------------------------------------------------------------------- #
# every placement goes through the plan


def test_reload_and_generations_keep_the_spec(plan8, rng):
    parts1 = rng.normal(size=(64, 5)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts1, min_bucket=4, max_bucket=8, plan=plan8)
    x = rng.normal(size=(5, 4)).astype(np.float32)
    eng.predict(x)
    parts2 = rng.normal(size=(128, 5)).astype(np.float32)
    eng.reload(parts2, tag="gen2")
    assert eng.particles.spec == (AXIS, None) and eng.n_particles == 128
    ref = PredictiveEngine("logreg", parts2, min_bucket=4, max_bucket=8, device="cpu")
    np.testing.assert_allclose(eng.predict(x)["mean"], ref.predict(x)["mean"], **LOGREG_TOL)
    parts3 = rng.normal(size=(64, 5)).astype(np.float32)
    eng.stage_candidate(parts3, tag="gen3")
    assert eng._cand_particles.spec == (AXIS, None)
    ref3 = PredictiveEngine("logreg", parts3, min_bucket=4, max_bucket=8, device="cpu")
    np.testing.assert_allclose(eng.predict(x, generation="candidate")["var"],
                               ref3.predict(x)["var"], **LOGREG_TOL)
    eng.promote_candidate()
    assert eng.particles.spec == (AXIS, None)
    eng.rollback()
    assert eng.particles.spec == (AXIS, None) and eng.n_particles == 128
    # a reload the mesh does not divide is replicated, and still served right
    with pytest.warns(UserWarning, match="not divisible"):
        eng.reload(parts2[:10])
    assert eng.particles.spec == ()
    ref10 = PredictiveEngine("logreg", parts2[:10], min_bucket=4, max_bucket=8, device="cpu")
    np.testing.assert_array_equal(eng.predict(x)["mean"], ref10.predict(x)["mean"])


def test_bf16_reload_keeps_dtype_and_spec(plan8, rng):
    eng = PredictiveEngine("logreg", rng.normal(size=(32, 5)).astype(np.float32),
                           min_bucket=4, max_bucket=8, plan=plan8, dtype="bfloat16")
    eng.reload(rng.normal(size=(32, 5)).astype(np.float32))
    assert eng.particles.dtype == torch.bfloat16 and eng.particles.spec == (AXIS, None)


def test_policied_reload_and_registry_engines_on_a_mesh(plan8, rng):
    from dist_svgd_torch.serving import ModelRegistry
    from dist_svgd_torch.telemetry.diagnostics import ReloadPolicy

    parts = rng.normal(size=(64, 5)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=8, plan=plan8,
                           reload_policy=ReloadPolicy(min_ess_frac=0.0))
    info = eng.reload(rng.normal(size=(64, 5)).astype(np.float32))
    assert info["generation_id"] == 2 and eng.particles.spec == (AXIS, None)
    assert eng.stats()["ensemble_health"] is not None
    reg = ModelRegistry(max_batch=8, max_wait_ms=1.0)
    try:
        tenant = reg.add_tenant("a", "logreg", particles=parts, plan=plan8, min_bucket=4,
                                max_bucket=8)
        assert tenant.engine.particles.spec == (AXIS, None)
        assert tenant.engine.stats()["plan"]["num_shards"] == 8
    finally:
        reg.close()


def test_chan_combine_near_saturated_probabilities_vs_float64(plan8):
    """Probabilities near 0 (logits around −12, relative spread 1e-5) and
    near 1 (logits around 12, spread 10%): the 8-way combine's variance
    against float64 over the same float32 probabilities, as close as the
    single-device two-pass variance.  ``E[p²] − E[p]²`` in float32 misses
    every row by more than 10%, so the case tells the two apart."""
    from dist_svgd_torch.models.logreg import posterior_predictive_prob

    rng = np.random.default_rng(3)
    n, f = 64, 4
    w = np.zeros((n, f), np.float32)
    w[:, 0] = 12.0 * (1.0 + 1e-5 * rng.standard_normal(n))
    w[:, 1] = 12.0 * (1.0 + 1e-1 * rng.standard_normal(n))
    parts = np.concatenate([np.zeros((n, 1), np.float32), w], axis=1).astype(np.float32)
    x = np.zeros((4, f), np.float32)
    x[0, 0], x[1, 1], x[2, 0], x[3, 1] = -1.0, 1.0, -0.9, 0.9
    eng = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=4, plan=plan8)
    single = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=4, device="cpu")
    probs = posterior_predictive_prob(torch.from_numpy(parts), torch.from_numpy(x)).numpy()
    want = probs.astype(np.float64).var(0)
    np.testing.assert_allclose(eng.predict(x)["var"], want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(single.predict(x)["var"], want, rtol=1e-5, atol=0)
    naive = (probs ** 2).mean(0) - probs.mean(0) ** 2
    assert np.min(np.abs(naive - want) / want) > 1e-1


# --------------------------------------------------------------------- #
# lanes and the HTTP front end over the mesh


def test_lanes_over_sharded_engine_concurrent_correctness(plan8, rng):
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    sharded = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16, plan=plan8)
    sharded.warmup()
    ref = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16, device="cpu")
    bat = MicroBatcher(sharded.predict, max_batch=16, lanes=2, max_wait_ms=1.0)
    xs = [rng.normal(size=(1 + i % 5, 4)).astype(np.float32) for i in range(12)]
    errs, outs = [], [[] for _ in xs]

    def fire(x, out):
        try:
            out.append(bat.submit(x).result(timeout=30))
        except Exception as e:  # pragma: no cover - failure surface
            errs.append(e)

    threads = [threading.Thread(target=fire, args=(x, o)) for x, o in zip(xs, outs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    bat.close()
    assert not errs and not any(t.is_alive() for t in threads)
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(o[0]["mean"], ref.predict(x)["mean"], **LOGREG_TOL)


def test_server_reports_mesh_devices_and_serves_sharded(plan8, rng):
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    eng = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16, plan=plan8)
    ref = PredictiveEngine("logreg", parts, min_bucket=4, max_bucket=16, device="cpu")
    x = rng.normal(size=(3, 4)).astype(np.float32)
    with PredictionServer(eng, port=0, lanes=2, max_batch=16, max_wait_ms=1.0) as srv:
        health = json.loads(urllib.request.urlopen(srv.url + "/healthz", timeout=10).read())
        assert health["devices"] == 8 and health["lanes"] == 2
        req = urllib.request.Request(srv.url + "/predict",
                                     json.dumps({"inputs": x.tolist()}).encode(),
                                     {"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=10).read())["outputs"]
        np.testing.assert_allclose(out["mean"], ref.predict(x)["mean"], **LOGREG_TOL)
