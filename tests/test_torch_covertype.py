"""The port's Covertype driver (``dist_svgd_torch/experiments/covertype.py``,
BASELINE.json config 4) and the pieces it adds: ``load_covertype`` bitwise
the JAX package's, the split logreg target, the driver's φ policy, its
refusals, and a small CPU run that emits the JAX driver's metrics keys."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_svgd_tpu.models import logreg as jlogreg
from dist_svgd_tpu.utils import datasets as jds

from dist_svgd_torch.experiments import covertype as tcov
from dist_svgd_torch.models.logreg import logreg_logp, make_logreg_split
from dist_svgd_torch.utils import datasets as tds
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(nrows=1200, nproc=4, nparticles=32, niter=2, batch_size=64)


@pytest.mark.parametrize("n_rows,seed", [(50_000, 0), (1000, 0), (777, 3)])
def test_load_covertype_bitwise_equal(n_rows, seed):
    (x, t), (jx, jt) = tds.load_covertype(n_rows, seed), jds.load_covertype(n_rows, seed)
    assert x.dtype == jx.dtype == np.float32 and t.dtype == jt.dtype == np.float64
    assert x.shape == (n_rows, 54) and np.array_equal(x, jx) and np.array_equal(t, jt)
    assert set(np.unique(t)) == {-1.0, 1.0}


def test_load_covertype_is_not_a_prefix_of_a_longer_load():
    """Labels are drawn before features: held-out rows must come from one
    load (the drivers cut the test rows off the end of it)."""
    short, long_ = tds.load_covertype(100)[0], tds.load_covertype(200)[0]
    assert not np.array_equal(short, long_[:100])


def test_make_logreg_split_matches_jax_and_sums_to_logp():
    rng = np.random.default_rng(2)
    theta, x = rng.normal(size=6), rng.normal(size=(9, 5))
    t = np.where(rng.normal(size=9) > 0, 1.0, -1.0)
    lik, prior = make_logreg_split()
    jlik, jprior = jlogreg.make_logreg_split()
    tt, data = torch.as_tensor(theta), (torch.as_tensor(x), torch.as_tensor(t))
    np.testing.assert_allclose(float(lik(tt, data)),
                               float(jlik(jnp.asarray(theta), (jnp.asarray(x), jnp.asarray(t)))),
                               rtol=1e-12)
    np.testing.assert_allclose(float(prior(tt)), float(jprior(jnp.asarray(theta))), rtol=1e-12)
    np.testing.assert_allclose(float(lik(tt, data) + prior(tt)), float(logreg_logp(tt, data)),
                               rtol=1e-12)


def test_resolve_phi_impl_policy(monkeypatch):
    """'auto' → 'cuda_bf16' on the card when minibatched and a shard's φ
    clears CUDA_MIN_PAIRS_BIG_D (JAX's gate (c)), else unchanged."""
    from dist_svgd_torch.ops import cuda_svgd

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tcov.resolve_phi_impl("auto", 256, 10_000, 8, cuda) == "cuda_bf16"
    assert tcov.resolve_phi_impl("auto", 1, 10_000, 8, cuda) == "cuda_bf16"
    assert tcov.resolve_phi_impl("auto", None, 10_000, 8, cuda) == "auto"
    assert tcov.resolve_phi_impl("auto", 0, 10_000, 8, cuda) == "auto"
    assert tcov.resolve_phi_impl("auto", 256, 10_000, 8, cpu) == "auto"
    assert tcov.resolve_phi_impl("cuda", 256, 10_000, 8, cuda) == "cuda"
    # a shard's φ below a line (the committed one is 0, no gate): (n //
    # nproc) · n pairs with n = 16
    assert tcov.resolve_phi_impl("auto", 256, 16, 8, cuda) == "cuda_bf16"
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS_BIG_D", (16 // 8) * 16 + 1)
    assert tcov.resolve_phi_impl("auto", 256, 16, 8, cuda) == "auto"
    assert tcov.resolve_phi_impl("auto", 256, 23, 8, cuda) == "auto"  # n drops to 16


@pytest.mark.parametrize("kw,item", [
    ({"exchange_every": 2, "checkpoint_every": 5}, "cadences are unsupported"),
    ({"exchange_every": 2, "resume": True}, "cadences are unsupported"),
    ({"exchange_every": 2, "log_every": 1}, "cadences are unsupported"),
    ({"exchange_every": 3}, "multiple of"),
    ({"nproc": 1, "exchange_every": 2}, "requires --nproc > 1"),
])
def test_driver_refuses_unported_options(kw, item):
    """The cadences and the lagged exchange are ported; what JAX's driver
    refuses, the port refuses with its ValueError: the cadences together
    with --exchange-every > 1, a --niter that is not a multiple of it, and
    a lagged single-device run."""
    with pytest.raises(ValueError, match=item):
        tcov.run(**{**SMALL, "device": "cpu", **kw})


def test_driver_runs_on_the_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcov.run(**SMALL)


def _jax_driver(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    spec = importlib.util.spec_from_file_location("jax_covertype",
                                                  ROOT / "experiments" / "covertype.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_driver_small_cpu_run_emits_jax_metrics_keys(monkeypatch):
    """A small CPU run of both drivers: the port's metrics carry every key
    of the JAX driver's (plus the device), its particles are finite, and
    its accuracy is a fraction."""
    final, metrics = tcov.run(**SMALL, device="cpu", bandwidth="median")
    _, jmetrics = _jax_driver(monkeypatch).run(**SMALL, bandwidth="median")
    assert set(jmetrics) <= set(metrics)
    assert metrics["device"] == "cpu" and metrics["phi_impl"] == "auto"
    assert metrics["batch_size"] == 64 and metrics["nparticles"] == 32
    assert final.shape == (32, 55) and np.isfinite(final).all()
    assert 0.0 <= metrics["test_acc"] <= 1.0 and metrics["updates_per_sec"] > 0


def test_driver_cli_writes_results(tmp_path, capsys):
    assert tcov.main(["--device", "cpu", "--nrows", "1200", "--nproc", "4",
                      "--nparticles", "32", "--niter", "2", "--batch-size", "0",
                      "--bandwidth", "2.0", "--results-dir", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["batch_size"] is None and printed["phi_impl"] == "auto"
    (out,) = tmp_path.iterdir()
    assert out.name == "covertype-1200-4-32-2-0.0001-0-all_particles-shard-0-h=2.0"
    assert json.loads((out / "metrics.json").read_text()) == printed
    assert np.load(out / "particles.npy").shape == (32, 55)
