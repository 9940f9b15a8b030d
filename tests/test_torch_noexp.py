"""The no-exp probe of the port (``phi_small_d_noexp``) against JAX's
``tools/pallas_autotune.py:phi_noexp``.

JAX's probe runs its Pallas kernel under the interpreter: ``phi_noexp`` looks
``pallas_call`` up on ``jax.experimental.pallas`` at call time, so the test
patches it to ``interpret=True`` for the call.  The CUDA kernel runs only on
the card; ``chip_smoke.py`` holds it against the plain version tested
here."""

import functools

import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.pallas_autotune import phi_noexp as jphi_noexp

from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import (
    PHI_IMPLS,
    phi_small_d_noexp_cuda,
    phi_small_d_noexp_plain,
    resolve_phi_fn,
)
from dist_svgd_torch.ops.kernels import RBF
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(k, m, d, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((k, d), (m, d), (m, d)))


def _f64_noexp(y, x, s):
    """The probe's function in float64, closed form."""
    y, x, s = (np.asarray(a, np.float64) for a in (y, x, s))
    kt = -np.minimum(((y[:, None, :] - x[None, :, :]) ** 2).sum(-1), 1e30)
    return (kt @ (s - 2.0 * x) + 2.0 * y * kt.sum(1)[:, None]) / x.shape[0]


@pytest.mark.parametrize("d", [1, 3, 8])
def test_noexp_plain_matches_jax_probe_interpret(monkeypatch, d):
    """At an m that is a multiple of JAX's column tile (so its probe pads no
    columns) and a k ragged against its row tile, the plain version is
    JAX's probe within 1e-5 of max|φ| in float32."""
    y, x, s = _inputs(200, 512, d)
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    want = np.asarray(jphi_noexp(jnp.asarray(y), jnp.asarray(x), jnp.asarray(s), 128, 256))
    got = phi_small_d_noexp_plain(torch.from_numpy(y)[None], torch.from_numpy(x),
                                  torch.from_numpy(s)[None])
    assert got.dtype == torch.float32 and got.shape == (1, 200, d)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("S,k,m,d", [(1, 37, 300, 3), (2, 50, 77, 5), (3, 8, 13, 1)])
def test_noexp_plain_matches_f64_closed_form_at_ragged_m(S, k, m, d):
    """Where m is not a multiple of any tile (JAX's probe sums its padding
    there), the plain version computes the defined function: the f64 closed
    form, per lane, within 1e-5 of max|φ| in float32; and exactly it in
    float64."""
    rng = np.random.default_rng(5)
    y, x, s = (rng.normal(size=(S, k, d)), rng.normal(size=(m, d)), rng.normal(size=(S, m, d)))
    want = np.stack([_f64_noexp(y[l], x, s[l]) for l in range(S)])
    got32 = phi_small_d_noexp_plain(*(torch.tensor(a, dtype=torch.float32) for a in (y, x, s)))
    np.testing.assert_allclose(got32.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    got64 = phi_small_d_noexp_plain(*(torch.tensor(a) for a in (y, x, s)))
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_noexp_clamps_distances_at_the_cap():
    """K' = −min(d², 1e30): a pair 1e20 apart contributes −1e30, not −1e40."""
    y = torch.tensor([[[0.0]]], dtype=torch.float64)
    x = torch.tensor([[1e20]], dtype=torch.float64)
    s = torch.zeros(1, 1, 1, dtype=torch.float64)
    # (K'·(s − 2x) + 2·y·K') / m with K' = −1e30
    assert float(phi_small_d_noexp_plain(y, x, s)) == pytest.approx(-1e30 * (-2e20))


def test_noexp_wrapper_takes_the_plain_version_on_cpu_and_refuses_d_9():
    y, x, s = _inputs(20, 30, 3)
    y, x, s = torch.from_numpy(y)[None], torch.from_numpy(x), torch.from_numpy(s)[None]
    cuda_svgd.reset_launch_counts()
    torch.testing.assert_close(phi_small_d_noexp_cuda(y, x, s),
                               phi_small_d_noexp_plain(y, x, s), rtol=0, atol=0)
    assert cuda_svgd.launch_counts["phi_small_d_noexp"] == 0
    y9, x9, s9 = (torch.zeros(1, 4, 9), torch.zeros(5, 9), torch.zeros(1, 5, 9))
    with pytest.raises(ValueError, match="phi_small_d_noexp takes d <= 8"):
        phi_small_d_noexp_cuda(y9, x9, s9)


def test_noexp_is_counted_and_reached_by_no_phi_impl(monkeypatch):
    """The probe has a launch count and a C symbol in the small-d library,
    and no φ backend routes to it."""
    assert "phi_small_d_noexp" in cuda_svgd.launch_counts
    assert cuda_svgd._KERNELS["phi_small_d_noexp"][:2] == ("phi_small_d",
                                                           "phi_small_d_noexp_launch")
    assert all(name != "phi_small_d_noexp"
               for tier in cuda_svgd._TIERS.values() for name, _, _ in tier)
    called = []
    monkeypatch.setattr(cuda_svgd, "phi_small_d_noexp_plain",
                        lambda *a: called.append(a))
    monkeypatch.setattr(cuda_svgd, "phi_small_d_noexp_cuda",
                        lambda *a: called.append(a))
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS", 0)
    y, x, s = (torch.zeros(2, 4, 3), torch.zeros(5, 3), torch.zeros(2, 5, 3))
    for impl in PHI_IMPLS:
        if impl != "cuda":  # 'cuda' needs CUDA tensors
            resolve_phi_fn(RBF(1.0), impl)(y, x, s)
    assert called == []
