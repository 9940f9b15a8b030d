"""The port's bench suite (``dist_svgd_torch/experiments/bench_suite.py``)
against JAX's (``experiments/bench_suite.py``), imported in process.

Each config and table function of both packages runs with its timing seam
(``_time_sampler_run`` / ``_time_dist_steps``) replaced by a recorder that
returns a wall of 1 s, so the test sees the sampler, step size and keyword
arguments each function hands to its timing, and the row it builds from
them.  Both get the same float64 numpy particles (the particle draws are
patched in both namespaces, as ``test_torch_logreg_driver.py`` does;
JAX's BNN draw is carried across), the port JAX's minibatch indices
through its private index seam; the captured samplers are then stepped a
few steps and held at the samplers' parity tolerance, 1e-10 relative
(``test_torch_sampler.py``, ``test_torch_minibatch.py``).  Widths are cut
to a few particles; the structure is the functions' own.

Also: the rows' keys (JAX's plus ``device``), ``_markdown``, the CLI flags
(JAX's click options, ``--backend`` read as ``--device``) and one CLI run,
the port's ``emulated`` rule, and the committed sklearn targets
(``acceptance_targets.json``) against a fresh sklearn computation on JAX's
loaders, whose data the port's loaders equal bit for bit."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu.utils.rng as jrng
from dist_svgd_tpu.utils import datasets as jdatasets
from dist_svgd_tpu.utils.rng import minibatch_key

from dist_svgd_torch.experiments import bench_suite as tbs
from dist_svgd_torch.utils import datasets as tdatasets

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-10, 1e-12
STEPS = 3


@pytest.fixture(scope="module")
def jbs():
    """JAX's suite (experiments/ is a script directory; it imports the repo
    root's bench.py)."""
    for path in (REPO, os.path.join(REPO, "experiments")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import bench_suite

    return bench_suite


def _draw(seed, n, d, num_shards=1, **_):
    return np.random.default_rng(1000 + seed + 7 * n + d).normal(size=(n, d))


def _capture(monkeypatch, mod, fn, *args, **kw):
    """Run ``fn`` with ``mod``'s timing seams recording their arguments."""
    calls = []

    def sampler_run(sampler, n, iters, step_size, initial_particles=None):
        calls.append(dict(sampler=sampler, n=n, iters=iters, step_size=step_size,
                          initial=initial_particles, kwargs={}, seam="run"))
        return 1.0

    def dist_steps(sampler, iters, step_size, **run_kwargs):
        calls.append(dict(sampler=sampler, n=None, iters=iters, step_size=step_size,
                          initial=None, kwargs=run_kwargs, seam="steps"))
        return 1.0

    monkeypatch.setattr(mod, "_time_sampler_run", sampler_run)
    monkeypatch.setattr(mod, "_time_dist_steps", dist_steps)
    out = fn(*args, **kw)
    return calls, out if isinstance(out, list) else [out]


def _describe(s):
    """What both packages' samplers must agree on."""
    k = s._kernel
    return {"class": type(s).__name__, "mode": getattr(s, "mode", None),
            "num_particles": getattr(s, "num_particles", None),
            "batch_size": s._batch_size, "log_prior": s._log_prior is not None,
            "kernel": (type(k).__name__, getattr(k, "bandwidth", None)),
            "phi_impl": s._phi_impl,
            "exchange_impl": getattr(s, "_exchange_impl", None),
            "wasserstein": getattr(s, "_include_wasserstein", None),
            "solver": getattr(s, "_wasserstein_solver", None),
            "shard_data": getattr(s, "_shard_data", None)}


def _jax_dist_indices(seed, n_local, batch, S):
    """JAX's DistSampler draw for step t, every shard."""
    def draw(t):
        key = jax.random.fold_in(minibatch_key(seed), t)
        return np.stack([np.asarray(jax.random.choice(jax.random.fold_in(key, r), n_local,
                                                      (batch,), replace=False))
                         for r in range(S)])
    return draw


def _jax_single_indices(seed, n_rows, batch):
    root = minibatch_key(seed)
    return lambda t: np.array(jax.random.choice(jax.random.fold_in(root, t), n_rows,
                                                (batch,), replace=False))


#: (name, function name, args, keyword arguments) — widths cut, structure kept.
CASES = [
    ("config1", "bench_logreg_single", (2,), {}),
    ("config2", "bench_gmm", (2,), {}),
    ("config3", "bench_logreg_sharded", (2,), dict(num_shards=4, n_particles=16)),
    ("config4", "bench_covertype_minibatch", (2,),
     dict(num_shards=4, n_particles=16, n_rows=400, batch_size=16)),
    ("config5", "bench_bnn", (2,), dict(n_particles=4, batch_size=16)),
    ("scaling", "scaling_table", (2,), dict(world_sizes=(1, 4))),
    ("scaling10k", "scaling_table_10k", (2,), dict(world_sizes=(2,), n_particles=16)),
    ("scaling_w2", "scaling_table_w2", (2,), dict(world_sizes=(2,), n_particles=16)),
    ("chunked_ab", "bench_chunked_ab", (2,), dict(num_shards=4, n_particles=16)),
]


@pytest.mark.parametrize("name,fn,args,kw", CASES, ids=[c[0] for c in CASES])
def test_samplers_and_rows_match_jax(monkeypatch, jbs, name, fn, args, kw):
    """The same samplers, step sizes and run arguments; rows equal but for
    ``device`` (the port's extra key), ``emulated`` (the port's rule) and
    the chunked leg's measured ``max_dispatch_wall_s``;
    a few float64 steps of every captured sampler from the same particles
    at 1e-10."""
    monkeypatch.setattr(jrng, "init_particles_per_shard", _draw)
    monkeypatch.setattr(tbs, "init_particles_per_shard", _draw)
    jcalls, jrows = _capture(monkeypatch, jbs, getattr(jbs, fn), *args, **kw)
    tcalls, trows = _capture(monkeypatch, tbs, getattr(tbs, fn), *args, device="cpu", **kw)
    assert len(jcalls) == len(tcalls) == len(jrows) == len(trows) > 0
    for jr, tr in zip(jrows, trows):
        assert [k for k in tr if k != "device"] == list(jr)
        assert list(tr).index("device") == list(tr).index("platform") + 1
        assert tr["device"] == "cpu" and tr["platform"] == jr["platform"] == "cpu"
        # the chunked leg's longest dispatch is a wall each package measures
        for key in set(jr) - {"emulated", "max_dispatch_wall_s"}:
            assert tr[key] == jr[key], key
        if "max_dispatch_wall_s" in tr:
            assert tr["max_dispatch_wall_s"] > 0
        if "emulated" in tr:
            assert tr["emulated"] is (tr["num_shards"] > 1)
    for jc, tc in zip(jcalls, tcalls):
        js, ps = jc["sampler"], tc["sampler"]
        assert (jc["seam"], jc["n"], jc["iters"], jc["step_size"], jc["kwargs"]) == \
            (tc["seam"], tc["n"], tc["iters"], tc["step_size"], tc["kwargs"])
        assert _describe(js) == _describe(ps)
        if jc["seam"] == "run":
            n = jc["n"]
            init = (np.asarray(jc["initial"], dtype=np.float64) if jc["initial"] is not None
                    else _draw(0, n, ps._d))
            if js._batch_size is not None:
                ps._batch_index_seam = _jax_single_indices(0, ps._data[0].shape[0],
                                                           js._batch_size)
            jf, _ = js.run(n, STEPS, jc["step_size"], seed=0, record=False,
                           initial_particles=jnp.asarray(init))
            pf, _ = ps.run(n, STEPS, tc["step_size"], seed=0, record=False,
                           initial_particles=init)
        else:
            if js._batch_size is not None:
                S = ps._num_shards
                ps._batch_index_seam = _jax_dist_indices(0, 400 // S, js._batch_size, S)
            jf = js.run_steps(STEPS, jc["step_size"], **jc["kwargs"])
            pf = ps.run_steps(STEPS, tc["step_size"], **tc["kwargs"])
            assert ps.particles.dtype == torch.float64
        np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)


def test_result_keys_are_jaxs_plus_device(jbs):
    """``_result``'s own keys: JAX's, then ``device``; extras appended."""
    dev = torch.device("cpu")
    t = tbs._result("x", 10, 5, 2.0, dev, extra=1)
    j = jbs._result("x", 10, 5, 2.0, extra=1)
    assert list(t) == list(j)[:7] + ["device"] + list(j)[7:]
    assert {k: t[k] for k in j} == j


MARKDOWN_ROWS = [
    {"config": "1:logreg-single-100p", "n_particles": 100, "n_iters": 100, "wall_s": 0.25,
     "updates_per_sec": 40000.0, "vs_reference_best": 95.01},
    {"config": "4:covertype-minibatch-10kp", "n_particles": 10000, "n_iters": 100,
     "wall_s": 0.5, "updates_per_sec": 2e6, "vs_reference_best": 4750.59,
     "target_acc": 0.876, "steps_to_target": 300, "final_acc": 0.8812},
    {"config": "5:bnn-uci-500p", "n_particles": 500, "n_iters": 100, "wall_s": 0.9,
     "updates_per_sec": 55555.6, "vs_reference_best": 131.96,
     "bayesridge_rmse": 1.2859, "steps_to_target": None, "final_rmse": 1.4},
]
SCALING_ROWS = [{"num_shards": ws, "wall_s": 0.1 * ws, "updates_per_sec": 1e4 / ws}
                for ws in (1, 2, 4, 8, 16)]


@pytest.mark.parametrize("results,scaling", [
    (MARKDOWN_ROWS, SCALING_ROWS), (MARKDOWN_ROWS[:1], []), ([], SCALING_ROWS[:2]),
])
def test_markdown_matches_jax(jbs, results, scaling):
    assert tbs._markdown(results, scaling) == jbs._markdown(results, scaling)


def test_flags_are_jaxs_click_options(jbs):
    """Every click option of JAX's CLI is an argparse option here, with its
    default; ``--backend`` is ``--device`` (default: the card)."""
    jax_opts = {}
    for p in jbs.cli.params:
        for opt in p.opts + p.secondary_opts:
            jax_opts[opt] = p.default
    port = {}
    for action in tbs.build_parser()._actions:
        for opt in action.option_strings:
            if opt not in ("-h", "--help"):
                port[opt] = action.default
    assert set(port) == (set(jax_opts) - {"--backend"}) | {"--device"}
    for opt, default in jax_opts.items():
        if opt.startswith("--no-") or opt == "--backend":
            continue
        assert port[opt] == default, opt
    assert port["--device"] is None


@pytest.fixture(scope="module")
def cli_run():
    """One CLI run on the CPU, the chain cut so the subprocess stays short."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    code = ("import sys; from dist_svgd_torch.experiments import bench_suite as b; "
            "b.CHAIN.update(samples=1, target_s=0.02); sys.exit(b.main(sys.argv[1:]))")
    return subprocess.run(
        [sys.executable, "-c", code, "--device", "cpu", "--configs", "1,2", "--iters", "2",
         "--no-scaling", "--table"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)


def test_cli_prints_rows_and_table(cli_run):
    import json

    assert cli_run.returncode == 0, cli_run.stderr
    lines = cli_run.stdout.splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["config"] for r in rows] == ["1:logreg-single-100p", "2:gmm-256p"]
    assert all(r["platform"] == "cpu" and r["device"] == "cpu" and r["updates_per_sec"] > 0
               for r in rows)
    assert "steps_to_target" not in rows[0]  # acceptance 'auto' is off on the CPU
    assert "| config | n | iters | wall (s) | updates/sec | × ref best (421/s) |" in lines
    assert any(ln.startswith("| 2:gmm-256p | 256 | 2 |") for ln in lines)


def test_cli_rejects_an_unknown_config():
    with pytest.raises(SystemExit) as e:
        tbs.main(["--device", "cpu", "--configs", "1,9", "--no-scaling"])
    assert e.value.code == 2


def test_emulated_is_more_than_one_shard(monkeypatch):
    """A DistSampler without a mesh runs every shard on one device, whatever
    the host's card count (JAX's rule, devices < shards, would call 8 shards
    on a 4-card host real)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [tbs._emulated(s) for s in (1, 2, 4, 8)] == [False, True, True, True]
    monkeypatch.setattr(tbs, "_time_dist_steps", lambda *a, **k: 1.0)
    assert tbs.bench_logreg_sharded(1, num_shards=4, n_particles=8, device="cpu")["emulated"]
    assert not tbs.scaling_table(1, world_sizes=(1,), device="cpu")[0]["emulated"]


def test_acceptance_without_a_committed_target_raises(monkeypatch):
    monkeypatch.setattr(tbs, "_time_dist_steps", lambda *a, **k: 1.0)
    monkeypatch.setattr(tbs, "_time_sampler_run", lambda *a, **k: 1.0)
    with pytest.raises(ValueError, match="n_rows=50000"):
        tbs.bench_covertype_minibatch(1, num_shards=2, n_particles=4, n_rows=400,
                                      batch_size=8, acceptance=True, device="cpu")
    with pytest.raises(ValueError, match="'boston'"):
        tbs.bench_bnn(1, n_particles=2, dataset="yacht", acceptance=True, device="cpu")


def sklearn_targets(load_covertype, load_uci_regression):
    """The acceptance rows' sklearn baselines, JAX's estimator settings on
    the given loaders (experiments/bench_suite.py:181-226, 264-311): what
    ``acceptance_targets.json`` holds."""
    from sklearn.ensemble import GradientBoostingRegressor
    from sklearn.linear_model import BayesianRidge, LogisticRegression

    x, t = load_covertype(50_000)
    n_test = 50_000 // 10
    sk = LogisticRegression(max_iter=200).fit(x[:-n_test], t[:-n_test])
    acc = float(sk.score(x[-n_test:], t[-n_test:]))
    split = load_uci_regression("boston", 0)

    def sk_rmse(model):
        pred = model.fit(split.x_train, split.y_train).predict(split.x_test)
        pred = pred * split.y_std + split.y_mean
        return float(np.sqrt(np.mean((pred - split.y_test) ** 2)))

    return {"covertype": {"n_rows": 50_000, "n_test": n_test, "sklearn_acc": acc,
                          "target_acc": acc - 0.01},
            "bnn": {"dataset": "boston", "split": 0,
                    "bayesridge_rmse": sk_rmse(BayesianRidge()),
                    "gbr_rmse_context": sk_rmse(GradientBoostingRegressor(random_state=0))}}


def test_acceptance_targets_match_sklearn():
    """The committed targets equal sklearn's on JAX's loaders at JAX's
    rounding (4 decimals)."""
    pytest.importorskip("sklearn")
    fresh = sklearn_targets(jdatasets.load_covertype, jdatasets.load_uci_regression)
    committed = tbs.acceptance_targets()
    for group, vals in fresh.items():
        for key, value in vals.items():
            want = committed[group][key]
            if isinstance(value, float):
                assert round(value, 4) == round(want, 4), (group, key)
            else:
                assert value == want, (group, key)


def test_port_loaders_equal_jaxs_bit_for_bit():
    jx, jt = jdatasets.load_covertype(50_000)
    tx, tt = tdatasets.load_covertype(50_000)
    assert jx.dtype == tx.dtype and jt.dtype == tt.dtype
    assert np.array_equal(jx, tx) and np.array_equal(jt, tt)
    js, ts = jdatasets.load_uci_regression("boston", 0), tdatasets.load_uci_regression("boston", 0)
    for field in ("x_train", "y_train", "x_test", "y_test", "x_mean", "x_std"):
        a, b = np.asarray(getattr(js, field)), np.asarray(getattr(ts, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (js.y_mean, js.y_std) == (ts.y_mean, ts.y_std)
