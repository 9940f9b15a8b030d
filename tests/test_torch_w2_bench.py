"""``dist_svgd_torch/tools/w2_bench.py`` against the JAX package's builds
of ``tools/w2_bench.py`` on the CPU.

Both packages get the same particles (numpy, float64) and the banana fold
42; JAX runs its ``'xla'`` φ and Sinkhorn route (``'auto'`` off the TPU),
the port its ``'torch'`` ones (``'auto'`` on the CPU).  Each timing row's
final particles and each ``--fidelity`` trajectory, step by step, are held
against JAX's at the W2 tolerances ``test_torch_distsampler.py``'s
Sinkhorn cases pin (rtol 1e-10, atol 1e-12).  The fidelity deviations are
differences of two W2 trajectories, so they are not compared with JAX's:
each trajectory is."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu.models.logreg import logreg_logp as jlogreg_logp
from dist_svgd_tpu.utils.datasets import load_benchmark as jload_benchmark

from dist_svgd_torch.ops import cuda_ot
from dist_svgd_torch.tools import w2_bench

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-10, 1e-12
N, SHARDS, K = 64, 4, 2


def init(seed=0):
    return np.random.default_rng(seed).normal(size=(N, 3))


def jax_sampler(parts, exchange="all_particles", **sinkhorn):
    """JAX's sampler of ``tools/w2_bench.py:84-96`` (``--fidelity``) and
    ``:123-134`` (the timing rows), on the given particles."""
    fold = jload_benchmark("banana", 42)
    data = (jnp.asarray(fold.x_train), jnp.asarray(fold.t_train.reshape(-1)))
    return jdt.DistSampler(
        SHARDS, jlogreg_logp, None, jnp.asarray(parts), data=data,
        exchange_particles=(exchange != "partitions"), exchange_scores=False,
        include_wasserstein=True, wasserstein_solver="sinkhorn", **sinkhorn)


@pytest.fixture(scope="module")
def timing_rows():
    return w2_bench.bench_rows(n=N, shards=SHARDS, iters_per_dispatch=K, samples=2,
                               device="cpu", init=init())


@pytest.mark.parametrize("row,tol,warm", [("fixed", None, False), ("tol", 1e-2, False),
                                          ("warm", 1e-2, True)])
def test_timing_row_final_particles_match_jax(timing_rows, row, tol, warm):
    """Each row's final particles: an untimed dispatch and two samples of
    K = 2 steps at 3e-3, h = 10 — JAX's schedule on its build."""
    js = jax_sampler(init(), sinkhorn_iters=200, sinkhorn_tol=tol, sinkhorn_warm_start=warm)
    for _ in range(3):
        js.run_steps(K, 3e-3, h=10.0)
    got = timing_rows["rows"][row]["final"]
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(js.particles), rtol=RTOL, atol=ATOL)


def test_timing_rows_ratios_and_deviations(timing_rows):
    rows = timing_rows["rows"]
    ms = {k: rows[k]["ms_per_step"] for k in ("fixed", "tol", "warm")}
    assert all(v > 0 for v in ms.values())
    assert timing_rows["tol_vs_fixed"] == pytest.approx(ms["fixed"] / ms["tol"])
    assert timing_rows["warm_vs_cold_tol"] == pytest.approx(ms["tol"] / ms["warm"])
    assert timing_rows["total"] == pytest.approx(ms["fixed"] / ms["warm"])
    assert timing_rows["dev_warm_vs_fixed"] == pytest.approx(
        np.max(np.abs(rows["fixed"]["final"] - rows["warm"]["final"])))


@pytest.mark.parametrize("exchange", ["all_particles", "partitions"])
def test_fidelity_trajectories_match_jax(exchange):
    """``--fidelity`` over 5 steps: the budget (8 iterations) and the
    reference (200) each step by step against JAX's, one step a dispatch at
    3e-4, h = 10; the pairing is JAX's."""
    out = w2_bench.fidelity_rows(n=N, shards=SHARDS, steps=5, exchange=exchange,
                                 device="cpu", init=init(1))
    jb = jax_sampler(init(1), exchange, sinkhorn_iters=8, sinkhorn_tol=1e-2,
                     sinkhorn_warm_start=True)
    jr = jax_sampler(init(1), exchange, sinkhorn_iters=200, sinkhorn_tol=1e-2,
                     sinkhorn_warm_start=True)
    assert out["pairing"] == jb._w2_pairing
    assert [s["step"] for s in out["steps"]] == [1, 2, 3, 4, 5]
    for k in range(5):
        np.testing.assert_allclose(out["budget_traj"][k],
                                   np.asarray(jb.run_steps(1, 3e-4, h=10.0)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["ref_traj"][k], np.asarray(jr.run_steps(1, 3e-4, h=10.0)),
                                   rtol=RTOL, atol=ATOL)
        dev = np.max(np.abs(out["budget_traj"][k] - out["ref_traj"][k]))
        assert out["steps"][k]["max_dev"] == pytest.approx(dev)
    assert out["max_dev"] == max(s["max_dev"] for s in out["steps"])
    assert out["max_rel"] == max(s["rel"] for s in out["steps"])


def test_no_fixed_skips_the_fixed_row(capsys):
    out = w2_bench.bench_rows(n=16, shards=2, iters_per_dispatch=1, samples=1, no_fixed=True,
                              device="cpu")
    assert list(out["rows"]) == ["tol", "warm"] and "tol_vs_fixed" not in out
    text = capsys.readouterr().out
    assert "warm vs cold-tol:" in text and "W2 fixed" not in text


def test_w2_bench_cli_timing(capsys):
    out = w2_bench.main(["--device", "cpu", "--n", "16", "--shards", "2",
                         "--iters-per-dispatch", "1", "--samples", "1",
                         "--sinkhorn-iters", "20"])
    assert list(out["rows"]) == ["fixed", "tol", "warm"]
    text = capsys.readouterr().out
    for line in ("devices: cpu", "W2 fixed 20 iters, cold (round-1 ref)",
                 "W2 tol=1e-2, cold start (round-2 incumbent)",
                 "W2 tol=1e-2 + warm-started duals (default)", "tol vs fixed:",
                 "max final-particle deviation vs fixed-20:"):
        assert line in text


def test_w2_bench_cli_fidelity(capsys):
    out = w2_bench.main(["--device", "cpu", "--n", "16", "--shards", "2", "--fidelity",
                         "--fidelity-steps", "2", "--exchange", "partitions"])
    assert out["pairing"] == "block" and len(out["steps"]) == 2
    text = capsys.readouterr().out
    assert "fidelity: n=16 partitions (pairing block), budget 8 vs ref 200 iters" in text
    assert "fidelity band over 2 steps" in text


def test_w2_bench_cpu_runs_the_torch_route_and_no_kernel():
    """On the CPU the Sinkhorn route is torch's: no hand kernel launches
    (they run only on CUDA tensors; ``chip_smoke.py`` counts them on the
    card)."""
    cuda_ot.reset_launch_counts()
    w2_bench.bench_rows(n=16, shards=2, iters_per_dispatch=1, samples=1, no_fixed=True,
                        device="cpu")
    assert sum(cuda_ot.launch_counts.values()) == 0


def test_w2_bench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        w2_bench.main([])
