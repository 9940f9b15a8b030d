"""The port's chunked φ forms (``ops.svgd.phi_chunked`` and
``phi_blockwise``) against JAX's, in float64, with the cases and tolerance of
tests/test_ring.py (ragged tails, chunks larger than the axis), and on
batched lanes against a loop of JAX calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_svgd_tpu.ops.kernels import RBF as JRBF
from dist_svgd_tpu.ops.svgd import phi_blockwise as jphi_blockwise
from dist_svgd_tpu.ops.svgd import phi_chunked as jphi_chunked

from dist_svgd_torch.ops import phi_blockwise, phi_chunked
from dist_svgd_torch.ops.kernels import RBF
from dist_svgd_torch.ops.svgd import phi
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(k, m, seed, S=None, d=3):
    rng = np.random.default_rng(seed)
    lead = () if S is None else (S,)
    return (rng.normal(size=lead + (k, d)), rng.normal(size=(m, d)),
            rng.normal(size=lead + (m, d)))


@pytest.mark.parametrize("chunk_size", [4, 5, 16, 100])
def test_phi_chunked_matches_jax(chunk_size):
    y, x, s = _inputs(6, 16, 13)
    want = np.asarray(jphi_chunked(jnp.asarray(y), jnp.asarray(x), jnp.asarray(s),
                                   chunk_size=chunk_size))
    got = phi_chunked(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s),
                      chunk_size=chunk_size)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("chunk_k,chunk_m", [(4, 5), (7, 16), (100, 3), (6, 100)])
def test_phi_blockwise_matches_jax(chunk_k, chunk_m):
    y, x, s = _inputs(13, 19, 17)
    want = np.asarray(jphi_blockwise(jnp.asarray(y), jnp.asarray(x), jnp.asarray(s),
                                     chunk_k=chunk_k, chunk_m=chunk_m))
    got = phi_blockwise(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s),
                        chunk_k=chunk_k, chunk_m=chunk_m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("fn,kw", [
    ("chunked", {"chunk_size": 5}),
    ("blockwise", {"chunk_k": 4, "chunk_m": 7}),
    ("blockwise", {"chunk_k": 100, "chunk_m": 100}),
])
@pytest.mark.parametrize("shared_x", [True, False])
def test_batched_lanes_match_a_loop_of_jax_calls(fn, kw, shared_x):
    """S = 2 lanes in one call, with a shared (m, d) or a per-lane
    (S, m, d) interaction set, at h = 2: each lane is JAX's call on it."""
    y, x, s = _inputs(11, 17, 23, S=2)
    xs = np.stack([x, x + 0.5]) if not shared_x else x
    jfn = {"chunked": jphi_chunked, "blockwise": jphi_blockwise}[fn]
    want = np.stack([np.asarray(jfn(jnp.asarray(y[l]),
                                    jnp.asarray(xs if shared_x else xs[l]),
                                    jnp.asarray(s[l]), JRBF(2.0), **kw))
                     for l in range(2)])
    tfn = {"chunked": phi_chunked, "blockwise": phi_blockwise}[fn]
    got = tfn(torch.from_numpy(y), torch.from_numpy(xs), torch.from_numpy(s), RBF(2.0), **kw)
    assert got.shape == (2, 11, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(got, phi(torch.from_numpy(y), torch.from_numpy(xs),
                                        torch.from_numpy(s), RBF(2.0)),
                               rtol=1e-12, atol=1e-14)


def test_blockwise_gram_blocks_stay_within_the_chunks(monkeypatch):
    """Every Gram block phi_blockwise forms is at most (S, chunk_m, chunk_k):
    its peak memory does not grow with k or m."""
    from dist_svgd_torch.ops import svgd

    seen = []
    orig = svgd.phi

    def spy(updated, interacting, scores, kernel=None):
        seen.append(updated.shape[:-2] + (interacting.shape[-2], updated.shape[-2]))
        return orig(updated, interacting, scores, kernel)

    monkeypatch.setattr(svgd, "phi", spy)
    y, x, s = _inputs(50, 61, 3, S=2)
    out = phi_blockwise(torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(s),
                        chunk_k=16, chunk_m=8)
    assert out.shape == (2, 50, 3)
    assert len(seen) == 4 * 8 and max(b[1] * b[2] for b in seen) == 8 * 16
