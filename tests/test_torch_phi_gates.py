"""The φ policy's pair-count gates (``ops/cuda_svgd.py``: ``CUDA_MIN_PAIRS``,
``CUDA_MIN_PAIRS_BIG_D``, ``TORCH_BLOCKWISE_MIN_PAIRS``) and the Covertype
driver's gate (c), against the JAX package's ``resolve_phi_fn`` and
``experiments/covertype.py:resolve_phi_impl`` at patched thresholds."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import dist_svgd_tpu.ops.pallas_svgd as jpallas
import dist_svgd_tpu.ops.svgd as jsvgd
from dist_svgd_tpu.ops.kernels import RBF as JRBF

from dist_svgd_torch.experiments import covertype as tcov
from dist_svgd_torch.ops import cuda_svgd, svgd
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF
from dist_svgd_torch.ops.cuda_svgd import resolve_phi_fn
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _inputs(S, k, m, d, seed=7, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(a, dtype=dtype) for a in
                 (rng.normal(size=(S, k, d)), rng.normal(size=(m, d)),
                  rng.normal(size=(S, m, d))))


@pytest.fixture
def spies(monkeypatch):
    """Record which φ the policy calls: 'kernel' (phi_cuda), 'phi' or
    'blockwise'."""
    calls = []
    for attr, label in (("phi_cuda", "kernel"), ("phi", "phi"),
                        ("phi_blockwise", "blockwise")):
        orig = getattr(cuda_svgd, attr)
        monkeypatch.setattr(cuda_svgd, attr,
                            lambda *a, _o=orig, _l=label, **kw: calls.append(_l) or _o(*a, **kw))
    return calls


@pytest.mark.parametrize("d", [3, 55, 753])
@pytest.mark.parametrize("S", [1, 8])
def test_auto_gate_routes_on_the_calls_pair_count(monkeypatch, spies, d, S):
    """Below its gate 'auto' calls the plain phi, at or above it phi_cuda;
    the count is S·k·m and the gate is the one for d's band."""
    k, m = 5, 7
    pairs = S * k * m
    gate, other = (("CUDA_MIN_PAIRS", "CUDA_MIN_PAIRS_BIG_D") if d <= cuda_svgd.SMALL_D
                   else ("CUDA_MIN_PAIRS_BIG_D", "CUDA_MIN_PAIRS"))
    y, x, s = _inputs(S, k, m, d)
    monkeypatch.setattr(cuda_svgd, other, 1)  # the other band's line plays no part
    for line, want in ((pairs + 1, "phi"), (pairs, "kernel"), (S * k, "kernel")):
        monkeypatch.setattr(cuda_svgd, gate, line)
        spies.clear()
        out = resolve_phi_fn(RBF(2.0), "auto")(y, x, s)
        assert spies == [want], (line, spies)
        torch.testing.assert_close(out, svgd.phi(y, x, s, RBF(2.0)), rtol=2e-5, atol=1e-6)


def test_auto_above_wide_d_max_takes_the_plain_phi_at_any_count(monkeypatch, spies):
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS_BIG_D", 1)
    y, x, s = _inputs(1, 3, 4, cuda_svgd.WIDE_D_MAX + 1)
    resolve_phi_fn(RBF(1.0), "auto")(y, x, s)
    assert spies == ["phi"]


@pytest.mark.parametrize("impl", ["torch", "auto"])
@pytest.mark.parametrize("d", [3, 55])
def test_plain_branches_switch_to_blockwise_at_the_line(monkeypatch, spies, impl, d):
    """'torch', and 'auto' where it takes the plain φ, run phi_blockwise at
    or above TORCH_BLOCKWISE_MIN_PAIRS and phi below; both equal phi at
    1e-12 in float64."""
    S, k, m = 2, 4100, 9  # k past phi_blockwise's 4096-row chunk: a ragged k tail
    y, x, s = _inputs(S, k, m, d)
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS", 1 << 40)
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS_BIG_D", 1 << 40)
    want = svgd.phi(y, x, s, RBF(3.0))
    for line, route in ((S * k * m + 1, "phi"), (S * k * m, "blockwise")):
        monkeypatch.setattr(cuda_svgd, "TORCH_BLOCKWISE_MIN_PAIRS", line)
        spies.clear()
        out = resolve_phi_fn(RBF(3.0), impl)(y, x, s)
        assert spies == [route]
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-14)


def test_adaptive_rbf_composes_with_the_gates(monkeypatch, spies):
    """The median bandwidth's rescaled call is gated on its own shapes,
    which are the call's: the result is the rescaling identity either side
    of the line."""
    S, k, m, d = 2, 6, 9, 3
    y, x, s = _inputs(S, k, m, d)
    h = cuda_svgd.median_bandwidth_approx(x, AdaptiveRBF().max_points)
    sh = torch.sqrt(h)
    want = svgd.phi(y / sh, x / sh, s * sh, RBF(1.0)) / sh
    for line, route in ((S * k * m + 1, "phi"), (S * k * m, "kernel")):
        monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS", line)
        spies.clear()
        out = resolve_phi_fn(AdaptiveRBF(), "auto")(y, x, s)
        assert spies == [route]
        torch.testing.assert_close(out, want, rtol=2e-5, atol=1e-6)


def test_auto_gates_follow_jax_at_patched_thresholds(monkeypatch):
    """At the same thresholds, the port's 'auto' launches its kernel exactly
    where JAX's (on a TPU) takes phi_pallas, lanes counted as batch_hint."""
    for name in ("PALLAS_MIN_PAIRS", "PALLAS_MIN_PAIRS_BIG_D"):
        monkeypatch.setattr(jpallas, name, 64)
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS", 64)
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS_BIG_D", 64)
    monkeypatch.setattr(jpallas, "pallas_available", lambda: True)
    for S, k, m, d in [(1, 7, 9, 3), (1, 8, 8, 3), (8, 2, 4, 3), (8, 1, 7, 55),
                       (1, 8, 8, 753), (2, 4, 7, 753), (1, 1, 3000, 2433)]:
        jroute = []
        monkeypatch.setattr(jpallas, "phi_pallas", lambda *a, **kw: jroute.append("kernel"))
        monkeypatch.setattr(jsvgd, "phi", lambda *a, **kw: jroute.append("phi"))
        rng = np.random.default_rng(0)
        jpallas.resolve_phi_fn(JRBF(1.0), "auto", batch_hint=S)(
            rng.normal(size=(k, d)), rng.normal(size=(m, d)), rng.normal(size=(m, d)))
        route = []
        monkeypatch.setattr(cuda_svgd, "phi_cuda", lambda *a, **kw: route.append("kernel"))
        monkeypatch.setattr(cuda_svgd, "phi", lambda *a, **kw: route.append("phi"))
        resolve_phi_fn(RBF(1.0), "auto")(*_inputs(S, k, m, d))
        assert route == jroute, (S, k, m, d)


def _jax_covertype(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "experiments"))
    spec = importlib.util.spec_from_file_location("jax_covertype_gate",
                                                  ROOT / "experiments" / "covertype.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_covertype_gate_c_matches_jax_on_a_grid(monkeypatch):
    """resolve_phi_impl decides as JAX's on every (batch_size, nparticles,
    nproc), on the card (JAX: a TPU) and off it, at equal thresholds."""
    jcov = _jax_covertype(monkeypatch)
    line = 5000
    monkeypatch.setattr(jpallas, "PALLAS_MIN_PAIRS_BIG_D", line)
    monkeypatch.setattr(cuda_svgd, "CUDA_MIN_PAIRS_BIG_D", line)
    names = {"pallas_bf16": "cuda_bf16", "auto": "auto", "pallas": "cuda", "xla": "torch"}
    checked = 0
    for on_card in (True, False):
        monkeypatch.setattr(jpallas, "pallas_available", lambda v=on_card: v)
        device = torch.device("cuda" if on_card else "cpu")
        for impl in ("auto", "pallas", "xla"):
            for batch in (None, 0, 1, 256):
                for n in (10, 64, 70, 71, 100, 141, 1000, 10_000):
                    for nproc in (1, 2, 3, 8):
                        want = jcov.resolve_phi_impl(impl, batch, n, nproc)
                        got = tcov.resolve_phi_impl(names[impl], batch, n, nproc, device)
                        assert got == names[want], (impl, batch, n, nproc, on_card)
                        checked += 1
    assert checked == 2 * 3 * 4 * 8 * 4
