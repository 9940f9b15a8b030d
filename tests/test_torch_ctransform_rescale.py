"""The soft c-transform kernel's schedule (dist_svgd_torch/csrc/ot_ctransform.cu),
checked without a card: a float32 numpy model of what the kernel computes
for a row — its m-chunks and 256-column tiles, the base-2 exponent built by
FMAs, the lazily moved reference M with its threshold OT_CT_TAU (read from
the source), the per-tile sums, ex2's flush below 2^-126 and the split
merge in split order — held against a float64 logsumexp, against the port's
plain version and against ``ctransform_reduce`` of the JAX package under the
Pallas interpreter, on adversarial rows: each chunk's maximum in its last
column, exponents spanning more than 300 in base 2, all columns far away.

Tolerance: ``SOFT_CT_TOL·(1 + max|ref|)`` with SOFT_CT_TOL = 1e-4, the soft
c-transform's rule in chip_smoke.py (a log, so its error is absolute).  The
card holds the kernel itself to the same rule on the same kinds of rows
(``chip_smoke.py:ct_rescale_rows``)."""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dist_svgd_tpu.ops import pallas_ot as jpo

from dist_svgd_torch.ops import _build, cuda_ot, cuda_svgd
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOFT_CT_TOL = 1e-4
F = np.float32
TAU = F(re.search(r"constexpr float OT_CT_TAU = ([0-9.]+)f;",
                  (_build.CSRC / "ot_ctransform.cu").read_text()).group(1))
LOG2E = F(1.4426950408889634)
LN2 = F(0.6931471805599453)
NEG_HUGE = F(-3.0e38)  # ot_common.cuh:OT_NEG_HUGE


def _fma(a, b, c):
    """a·b + c in one rounding to float32 (the product of two float32s is
    exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F)


def _ex2(z):
    """ex2.approx.ftz: 2^z, results below 2^-126 flushed to 0."""
    with np.errstate(over="ignore"):
        r = np.exp2(z.astype(np.float64)).astype(F)
    return np.where(r < F(2.0 ** -126), F(0), r)


def kernel_model(rows, cols, pot, inv_reg, nsplit, chunk, tile=cuda_ot._TILE):
    """The soft c-transform of one lane as the kernel schedules it, in
    float32: rows ``(k, d)``, cols ``(m, d)``, pot ``(m,)``.  Returns
    ``(out (k,), rescales)`` — the natural-log values and how many pairs
    moved a row's reference."""
    y, x, p = rows.astype(F), cols.astype(F), pot.astype(F)
    k, d = y.shape
    m = x.shape[0]
    s = np.full(k, F(F(inv_reg) * LOG2E), F)
    zero = np.zeros(k, F)

    def exponent(j, negm):  # ot_exponent2: fma(p_j − Σ_c diff², s, −M)
        t = np.full(k, p[j], F)
        for c in range(d):
            diff = (y[:, c] - x[j, c]).astype(F)
            t = _fma(-diff, diff, t)
        return _fma(t, s, negm)

    rescales = 0
    parts = []
    with np.errstate(over="ignore", invalid="ignore"):
        for split in range(nsplit):
            j0, j1 = split * chunk, min(m, (split + 1) * chunk)
            negm = -np.maximum(exponent(j0, zero), NEG_HUGE)  # the chunk's first column
            acc = zero
            for t0 in range(j0, j1, tile):
                tacc = zero
                for j in range(t0, min(j1, t0 + tile)):
                    dz = exponent(j, negm)
                    big = dz > TAU
                    if big.any():  # the warp's vote
                        rescales += int(big.sum())
                        r = _ex2(-dz)
                        acc = np.where(big, acc * r, acc)
                        tacc = np.where(big, tacc * r, tacc)
                        negm = np.where(big, -exponent(j, zero), negm)
                        dz = np.where(big, F(0), dz)
                    tacc = (tacc + _ex2(dz)).astype(F)
                acc = (acc + tacc).astype(F)
            parts.append((-negm, acc))
    # ot_ctransform_finalize: merge in split order, base 2
    run, total = parts[0]
    for mp, sp in parts[1:]:
        mx = np.maximum(run, mp)
        total = (total * np.exp2(run - mx) + sp * np.exp2(mp - mx)).astype(F)
        run = mx
    return ((run + np.log2(total)) * LN2).astype(F), rescales


def lse_f64(rows, cols, pot, inv_reg):
    c = ((rows[:, None, :].astype(np.float64) - cols[None, :, :]) ** 2).sum(-1)
    e = (pot[None, :].astype(np.float64) - c) * inv_reg
    mx = e.max(axis=1)
    return mx + np.log(np.exp(e - mx[:, None]).sum(axis=1))


def adversarial(case, k, m, d, chunk, seed):
    """One lane's rows, columns and potentials in the solve's rescaled units
    (mean C ≈ 20), made adversarial for the lazy reference."""
    rng = np.random.default_rng(seed)
    scale = (20.0 / (2 * d)) ** 0.5
    rows = (scale * rng.normal(size=(k, d))).astype(F)
    cols = (scale * rng.normal(size=(m, d))).astype(F)
    pot = (4.0 * rng.normal(size=m)).astype(F)
    if case == "max last in chunk":
        last = [min(m, c + chunk) - 1 for c in range(0, m, chunk)]
        pot[last] = pot.max() + 1000.0 + rng.uniform(size=len(last)).astype(F)
    elif case == "span > 300":
        pot = np.linspace(-250.0, 0.0, m).astype(F)
    else:  # far: C ≈ 3e6, every term of a naive exp underflows
        cols = cols + F(1000.0)
    return rows, cols, pot


def _card_split(S, k, m):
    """The kernel's (nsplit, chunk) for lanes of k rows on a 132-SM card."""
    saved = dict(cuda_svgd._SM_COUNTS)
    cuda_svgd._SM_COUNTS[0] = 132
    try:
        return cuda_ot._split(S, k, m, torch.device("cuda", 0),
                              cuda_ot._ROWS * cuda_ot._CT_ROWS_PER_THREAD,
                              cuda_ot._CT_BLOCKS_PER_SM)
    finally:
        cuda_svgd._SM_COUNTS.clear()
        cuda_svgd._SM_COUNTS.update(saved)


def test_tau_keeps_every_sum_inside_float32():
    """A term is at most 2^τ and a chunk at most 2^31 columns: the sums stay
    far below float32's 2^128."""
    assert 0 < TAU and 31 + TAU <= 100


# (shape, split): 16 rows of a lane of the streaming route's Pᵀu-side soft
# c-transform (8 × 100,000 rows against 12,500 columns, the kernel's split
# on an H100), and a ragged m with three chunks of 3, 3 and 2 tiles (the
# last one short).
SCHEDULES = {"streaming lane": (16, 12_500, 3, _card_split(8, 100_000, 12_500)),
             "ragged": (24, 2000, 8, (3, 768))}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("case", ["max last in chunk", "span > 300", "far"])
def test_model_of_the_schedule_matches_f64_and_jax(case, schedule):
    k, m, d, (nsplit, chunk) = SCHEDULES[schedule]
    assert (nsplit - 1) * chunk < m <= nsplit * chunk
    rows, cols, pot = adversarial(case, k, m, d, chunk, seed=len(case) + m)
    got, rescales = kernel_model(rows, cols, pot, 1.0, nsplit, chunk)
    want = lse_f64(rows, cols, pot, 1.0)
    tol = SOFT_CT_TOL * (1.0 + np.abs(want).max())
    assert np.isfinite(got).all()
    assert rescales > 0  # the rows do move their references
    assert np.abs(got - want).max() <= tol
    jax_out = np.asarray(jpo.ctransform_reduce(jnp.asarray(rows), jnp.asarray(cols),
                                               jnp.asarray(pot), 1.0, True, interpret=True))
    assert np.abs(got - jax_out).max() <= tol
    plain = cuda_ot.ctransform_reduce(torch.from_numpy(rows)[None], torch.from_numpy(cols)[None],
                                      torch.from_numpy(pot)[None], soft=True)[0].numpy()
    assert np.abs(got - plain).max() <= tol


def test_model_at_a_solve_scale_inv_reg():
    """inv_reg ≠ 1 scales the base-2 exponent, and the finalize returns
    natural-log units: a Sinkhorn-like potential (a hard c-transform) at
    inv_reg = 3.7, the reference moving where the chunk's first column is
    far below its maximum."""
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(20, 3)).astype(F)
    cols = (rng.normal(size=(900, 3)) + 0.3).astype(F)
    c = ((rows[:, None, :] - cols[None]) ** 2).sum(-1)
    pot = (c - (c.min(axis=1) - 0.5)[:, None]).min(axis=0).astype(F)  # min_i (C_ij − f_i)
    pot[0] = pot.min() - 40.0  # the chunks' first columns start low
    pot[512] = pot[0]
    got, rescales = kernel_model(rows, cols, pot, 3.7, 2, 512)
    want = lse_f64(rows, cols, pot, 3.7)
    assert rescales > 0
    assert np.abs(got - want).max() <= SOFT_CT_TOL * (1.0 + np.abs(want).max())
