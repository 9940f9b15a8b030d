"""The bf16 tiers of the port's φ (phi_impl='cuda_bf16') against the JAX
package's 'pallas_bf16' tier.

The same numpy inputs go through ``phi_pallas(..., gram_dtype=bfloat16)``
under the Pallas interpreter and through the port's plain versions of the
two bf16 kernels (float32, on the CPU): the small-d bf16-exp tier and the
big-d bf16x3 tier (``_dot3``).  Both sides take exact bf16 products with
float32 sums in other orders, so they agree to ``1e-4·max|φ|``.  Against
the exact float64 φ they keep JAX's own budget, ``2e-2·max|φ|``
(tests/test_pallas.py).  The CUDA kernels run only on the card;
``chip_smoke.py`` holds them against these plain versions there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.ops.kernels import RBF as JRBF
from dist_svgd_tpu.ops.pallas_svgd import _dot3 as jdot3
from dist_svgd_tpu.ops.pallas_svgd import phi_pallas
from dist_svgd_tpu.ops.svgd import phi as jphi

from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import SMALL_D, phi_cuda

BF16_RTOL = 1e-4
ORACLE_RTOL = 2e-2

# (S, k, m, d, h, per-lane x): tests/test_pallas.py's two bf16 shapes at its
# h = 2d, then batched lanes, per-lane interaction sets, ragged d = 13, the
# widest d = 128 and the Covertype width d = 55 at the path's h = 1.
CASES = [
    (1, 50, 37, 3, 6.0, False),
    (1, 40, 60, 55, 110.0, False),
    (3, 21, 40, 4, 8.0, False),
    (2, 19, 33, 7, 1.0, True),
    (3, 21, 40, 13, 26.0, True),
    (2, 17, 29, 128, 256.0, False),
    (2, 30, 70, 55, 1.0, False),
]


def _inputs(S, k, m, d, per_lane, seed=41):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, m, d) if per_lane else (m, d)).astype(np.float32)
    y = rng.normal(size=(S, k, d)).astype(np.float32)
    s = rng.normal(size=(S, m, d)).astype(np.float32)
    return y, x, s


def _lane_x(x, l):
    return x[l] if x.ndim == 3 else x


def _jax_bf16(y, x, s, h):
    return np.stack([
        np.asarray(phi_pallas(jnp.asarray(y[l]), jnp.asarray(_lane_x(x, l)),
                              jnp.asarray(s[l]), bandwidth=h, block_k=128, block_m=128,
                              interpret=True, gram_dtype=jnp.bfloat16))
        for l in range(y.shape[0])])


def _port_bf16(y, x, s, h):
    got = phi_cuda(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s), h,
                   tier="bf16")
    assert got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("S,k,m,d,h,per_lane", CASES)
def test_bf16_plain_matches_phi_pallas_bf16_interpret(S, k, m, d, h, per_lane):
    y, x, s = _inputs(S, k, m, d, per_lane)
    want = _jax_bf16(y, x, s, h)
    got = _port_bf16(y, x, s, h)
    assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()


@pytest.mark.parametrize("S,k,m,d,h,per_lane", CASES)
def test_bf16_plain_within_budget_of_exact_f64(S, k, m, d, h, per_lane):
    y, x, s = _inputs(S, k, m, d, per_lane)
    want = np.stack([
        np.asarray(jphi(jnp.asarray(y[l], jnp.float64), jnp.asarray(_lane_x(x, l), jnp.float64),
                        jnp.asarray(s[l], jnp.float64), JRBF(h)))
        for l in range(S)])
    got = _port_bf16(y, x, s, h)
    assert np.abs(got - want).max() <= ORACLE_RTOL * np.abs(want).max()


def test_split_and_dot3_match_jax():
    """The bf16 split is bitwise JAX's (round to nearest even, residual of
    the f32 difference), and the three-pass product agrees with ``_dot3``."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(33, 55)).astype(np.float32) * 3
    b = rng.normal(size=(55, 41)).astype(np.float32)
    hi, lo = cuda_svgd._bf16_split(torch.from_numpy(a))
    ja = jnp.asarray(a)
    jhi = ja.astype(jnp.bfloat16)
    jlo = (ja - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo.astype(jnp.float32)))
    got = cuda_svgd._dot3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jdot3(ja, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # three passes lose only the lo·lo term: ~2⁻¹⁶ of the product
    np.testing.assert_allclose(got, a.astype(np.float64) @ b, rtol=0, atol=2e-3)


def test_small_d_bf16_rounds_the_exponent_only():
    """The small-d bf16 tier rounds the exponent −d²/h to bf16 and keeps
    its exp in f32, as the JAX program runs the TPU kernel: with xs = 0 the
    drive vanishes and φ·m·h/2 = y·K through a one-column set."""
    y = torch.tensor([[[0.7, -0.3, 1.1]]], dtype=torch.float32)
    x = torch.tensor([[0.1, 0.2, 0.3]], dtype=torch.float32)
    s = (2.0 / 1.3) * x[None]  # xs = s − (2/h)·x = 0
    out = cuda_svgd.phi_small_d_bf16_plain(y, x, s, 1.3)
    kval = float(out[0, 0, 0] * 1.3 / 2.0 / y[0, 0, 0])
    d2 = float(((y[0, 0] - x[0]) ** 2).sum())
    e = torch.tensor(-d2 / 1.3, dtype=torch.float32).to(torch.bfloat16).float()
    want = float(torch.exp(e))
    assert abs(kval - want) <= 1e-6 * want
    assert abs(want - np.exp(-d2 / 1.3)) > 1e-4 * want  # the rounding is visible
    assert float(torch.tensor(want).to(torch.bfloat16).float()) != want  # K stays f32


def test_bf16_tier_routes_by_d_and_casts_f64():
    """d ≤ SMALL_D takes the small-d bf16 tier, d > SMALL_D the bf16x3 one;
    float64 is cast down and back, as phi_pallas does."""
    for d in (SMALL_D, SMALL_D + 1):
        y, x, s = (torch.from_numpy(a.astype(np.float64)) for a in _inputs(2, 5, 9, d, False))
        got = phi_cuda(y, x, s, 2.0, tier="bf16")
        assert got.dtype == torch.float64
        plain = (cuda_svgd.phi_small_d_bf16_plain if d <= SMALL_D
                 else cuda_svgd.phi_big_d_bf16x3_plain)
        want = plain(y.float(), x.float(), s.float(), 2.0).double()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown tier"):
        phi_cuda(y, x, s, 2.0, tier="fp8")
