"""φ beyond d = 128 (the wide-d kernels' plain versions), the per-step
median bandwidth, and the φ policy at large d, against the JAX package.

The wide-d kernels (``csrc/phi_wide_d.cu``, ``csrc/phi_wide_d_bf16x3.cu``)
run only on the card, where ``chip_smoke.py`` holds them against their plain
versions — the big-d ones, one function at every d, as ``_phi_kernel`` is.
Here those plain versions take the same numpy inputs as
``phi_pallas(interpret=True)`` at d = 129, 753 and 2432 (the largest d the
TPU kernel takes): the exact tier at tests/test_pallas.py's ``rtol=2e-5,
atol=2e-6``, the bf16x3 tier at ``BF16_RTOL·max|φ|`` as
tests/test_torch_phi_bf16.py holds it at d ≤ 128."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_svgd_tpu.ops.kernels import AdaptiveRBF as JAdaptiveRBF
from dist_svgd_tpu.ops.kernels import median_bandwidth_approx as jmba
from dist_svgd_tpu.ops.pallas_svgd import fits_vmem_big_d, phi_pallas
from dist_svgd_tpu.ops.pallas_svgd import resolve_phi_fn as jresolve

from dist_svgd_torch.ops import cuda_svgd
from dist_svgd_torch.ops.cuda_svgd import (
    BIG_D_MAX,
    WIDE_D_MAX,
    phi_big_d_bf16x3_plain,
    phi_big_d_plain,
    phi_cuda,
    resolve_phi_fn,
)
from dist_svgd_torch.ops.kernels import RBF, AdaptiveRBF, median_bandwidth_approx
from dist_svgd_torch.ops.svgd import phi

BF16_RTOL = 1e-4


def _inputs(S, k, m, d, per_lane=False, scale=1.0, seed=11):
    """``per_lane``: x of shape (S, m, d); ``"self"``: y is x (one lane)."""
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(S, m, d) if per_lane is True else (m, d))).astype(np.float32)
    y = x[None].copy() if per_lane == "self" else (
        scale * rng.normal(size=(S, k, d))).astype(np.float32)
    s = rng.normal(size=(S, m, d)).astype(np.float32)
    return y, x, s


def _pallas(y, x, s, h, **kw):
    return np.stack([
        np.asarray(phi_pallas(jnp.asarray(y[l]), jnp.asarray(x[l] if x.ndim == 3 else x),
                              jnp.asarray(s[l]), bandwidth=h, interpret=True, **kw))
        for l in range(y.shape[0])])


def test_wide_d_max_is_the_tpu_kernels_largest_d():
    """The port takes every d the TPU kernel takes: fits_vmem_big_d admits
    d ≤ 2432 and no more."""
    assert fits_vmem_big_d(WIDE_D_MAX) and not fits_vmem_big_d(WIDE_D_MAX + 1)
    assert BIG_D_MAX == 128 < WIDE_D_MAX


# (S, k, m, d, h, per-lane x, input scale): the ragged d = 129 next to the
# big-d kernels' cap, the BNN's d = 753 at a median-like h and, with y = x,
# at the driver's h = 1 on BNN-sized particles (|θ|² ≈ 60, every
# off-diagonal K underflows), two lanes with their own sets, and d = 2432 at
# h = 2d.
CASES = [
    (1, 20, 33, 129, 258.0, False, 1.0),
    (1, 24, 40, 753, 240.0, False, 1.0),
    (1, 40, 40, 753, 1.0, "self", 0.28),
    (2, 9, 17, 753, 1506.0, True, 1.0),
    (1, 6, 10, 2432, 4864.0, False, 1.0),
]


@pytest.mark.parametrize("S,k,m,d,h,per_lane,scale", CASES)
def test_exact_plain_matches_phi_pallas_interpret(S, k, m, d, h, per_lane, scale):
    y, x, s = _inputs(S, k, m, d, per_lane, scale)
    want = _pallas(y, x, s, h)
    got = phi_cuda(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s), h)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("S,k,m,d,h,per_lane,scale", CASES)
def test_bf16x3_plain_matches_phi_pallas_bf16_interpret(S, k, m, d, h, per_lane, scale):
    y, x, s = _inputs(S, k, m, d, per_lane, scale)
    want = _pallas(y, x, s, h, gram_dtype=jnp.bfloat16)
    got = phi_cuda(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s), h,
                   tier="bf16")
    assert np.abs(got.numpy() - want).max() <= BF16_RTOL * np.abs(want).max()


def test_wide_d_routes_to_the_big_d_plain_versions():
    """On CPU tensors the wide band runs the big-d plain versions, bit for
    bit: one plain function at every d."""
    y, x, s = (torch.from_numpy(a) for a in _inputs(2, 5, 7, 300))
    torch.testing.assert_close(phi_cuda(y, x, s, 3.0), phi_big_d_plain(y, x, s, 3.0),
                               rtol=0, atol=0)
    torch.testing.assert_close(phi_cuda(y, x, s, 3.0, tier="bf16"),
                               phi_big_d_bf16x3_plain(y, x, s, 3.0), rtol=0, atol=0)


@pytest.mark.parametrize("n,d,max_points", [(50, 3, 1024), (200, 753, 1024), (2500, 4, 1024),
                                            (300, 20, 64)])
def test_median_bandwidth_approx_matches_jax(n, d, max_points):
    """Within the bracket's resolution, max d²/16⁴ (over log(n + 1)): a
    distance within an ulp of a threshold may flip one count, so the two
    are not held bitwise."""
    x = np.random.default_rng(n + d).normal(size=(n, d))
    got = float(median_bandwidth_approx(torch.from_numpy(x), max_points))
    want = float(jmba(jnp.asarray(x), max_points))
    stride = -(-n // max_points) if n > max_points else 1
    sub = x[::stride]
    res = ((sub[:, None] - sub[None]) ** 2).sum(-1).max() / 16 ** 4 / np.log(n + 1.0)
    assert abs(got - want) <= res


def test_median_bandwidth_approx_batched_lanes_and_floor():
    """Leading dims are independent sets, each with its own estimate; an
    all-identical set floors at 1e-12 / log(n + 1)."""
    x = np.random.default_rng(2).normal(size=(3, 40, 6))
    got = median_bandwidth_approx(torch.from_numpy(x))
    assert got.shape == (3,)
    for l in range(3):
        np.testing.assert_allclose(float(got[l]), float(jmba(jnp.asarray(x[l]))), rtol=1e-12)
    same = median_bandwidth_approx(torch.ones(10, 4, dtype=torch.float64))
    np.testing.assert_allclose(float(same), 1e-12 / np.log(11.0), rtol=1e-12)


@pytest.mark.parametrize("S,k,m,d,per_lane", [(1, 12, 30, 3, False), (2, 10, 25, 140, False),
                                              (3, 8, 20, 12, True)])
def test_adaptive_rbf_matches_jax_xla(S, k, m, d, per_lane):
    """resolve_phi_fn(AdaptiveRBF(), 'torch') against JAX's
    resolve_phi_fn(AdaptiveRBF(), 'xla'), float64: h re-estimated from each
    lane's interaction set, φ through the rescaling identity."""
    rng = np.random.default_rng(d)
    y = rng.normal(size=(S, k, d))
    x = rng.normal(size=(S, m, d) if per_lane else (m, d))
    s = rng.normal(size=(S, m, d))
    jfn = jresolve(JAdaptiveRBF(), "xla")
    want = np.stack([np.asarray(jfn(jnp.asarray(y[l]), jnp.asarray(x[l] if per_lane else x),
                                    jnp.asarray(s[l]))) for l in range(S)])
    for impl in ("torch", "auto"):
        got = resolve_phi_fn(AdaptiveRBF(), impl)(
            torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s))
        rtol = 1e-10 if impl == "torch" else 2e-5  # 'auto' is float32 inside
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * 1e-2)


def test_rescaling_identity_equals_the_fixed_bandwidth():
    """φ_h(y; x, s) = φ₁(y/√h; x/√h, √h·s)/√h: AdaptiveRBF equals RBF at the
    estimated h."""
    rng = np.random.default_rng(4)
    y, x, s = (torch.from_numpy(rng.normal(size=shape)) for shape in
               ((2, 7, 5), (11, 5), (2, 11, 5)))
    h = float(median_bandwidth_approx(x))
    torch.testing.assert_close(resolve_phi_fn(AdaptiveRBF(), "torch")(y, x, s),
                               phi(y, x, s, RBF(h)), rtol=1e-12, atol=1e-14)


def test_auto_beyond_wide_d_max_takes_the_plain_phi():
    """Beyond WIDE_D_MAX 'auto' takes ops.svgd.phi (JAX's 'auto' takes the
    XLA φ beyond fits_vmem_big_d); 'cuda' and phi_cuda refuse there."""
    y, x, s = (torch.from_numpy(a) for a in _inputs(1, 3, 4, WIDE_D_MAX + 1))
    torch.testing.assert_close(resolve_phi_fn(RBF(2.0), "auto")(y, x, s),
                               phi(y, x, s, RBF(2.0)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="cap"):
        phi_cuda(y, x, s, 2.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_phi_fn(RBF(2.0), "cuda")(y, x, s)


def test_wide_wrappers_refuse_cpu_tensors_and_other_d():
    y, x, s = (torch.from_numpy(a) for a in _inputs(1, 4, 5, 200))
    for wrapper in (cuda_svgd.phi_wide_d_cuda, cuda_svgd.phi_wide_d_bf16x3_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(y, x, s)
    for d in (BIG_D_MAX, WIDE_D_MAX + 1):
        y, x, s = (torch.from_numpy(a) for a in _inputs(1, 2, 3, d))
        with pytest.raises(ValueError, match=f"128 < d <= {WIDE_D_MAX}"):
            cuda_svgd.phi_wide_d_cuda(y, x, s)
        with pytest.raises(ValueError, match=f"128 < d <= {WIDE_D_MAX}"):
            cuda_svgd.phi_wide_d_bf16x3_cuda(y, x, s)
    assert cuda_svgd.launch_counts["phi_wide_d"] == cuda_svgd.launch_counts[
        "phi_wide_d_bf16x3"] == 0
    with pytest.raises(ValueError, match="unknown phi_impl"):
        cuda_svgd.load_kernel(753, "fp8")
    cuda_svgd.load_kernel(WIDE_D_MAX + 1)  # 'auto' runs the plain φ there: nothing to load
    cuda_svgd.load_kernel(753, "torch_bf16")  # the plain versions: nothing to load
