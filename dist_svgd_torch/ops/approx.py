"""Sub-quadratic φ: random-feature and Nyström kernel approximations.

Counterpart of ``dist_svgd_tpu/ops/approx.py``.  Every exact φ backend
evaluates the RBF Gram matrix — O(n²) pairwise interactions a step.  The
two approximations here have the exact backends' signature
``phi_fn(updated, interacting, scores)`` on batched lanes (``(..., k, d)``
against ``(..., m, d)``), so everything built on that seam — the exchange
modes, the ring, the chunked executors, the W2 term — composes through
:func:`~dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn` unchanged:

- **Random Fourier features** (Rahimi & Recht 2007): ``k(x, y) =
  exp(-‖x−y‖²/h) = E_w[cos(wᵀ(x−y))]`` with ``w ~ N(0, (2/h)·I)``.  With a
  shared R-frequency bank the drive term is two feature-space matmuls
  through the ``(2R, d)`` summary ``Φ(X)ᵀS`` and the repulsive term one
  more through the analytic feature gradient — O((m+k)·R·d), no ``(m, k)``
  Gram.  Error ~O(1/√R), dialled by ``num_features``.
- **Nyström landmarks**: ``k̂(x, y) = k(x, Z) (K_ZZ + λI)⁻¹ k(Z, y)`` over
  an evenly-strided L-point landmark set Z taken from each call's
  interaction set (no carried state).  Both φ terms factor through one
  Cholesky factor of the (L, L) landmark system — O(n·L·d + L³), exact as
  L → m.

Both are **linear in the interaction set**, so the ring's hop-accumulated
φ and the chunked executors need no change: each ring hop approximates its
visiting block with that block's own features or landmarks.

These are plain torch (``torch.matmul``, ``torch.linalg.cholesky_ex``,
elementwise ops) on the tensors' device: the JAX package has no Pallas tier
for them either, and no hand kernel is involved.  A failed Cholesky factor
becomes NaN on the device (``cholesky_ex``'s status, never read on the
host), as JAX's ``cho_factor`` gives NaN.

Bandwidth discipline: the closed forms are functions of ONE static
bandwidth.  ``kernel='median'`` resolves the bandwidth before the bank is
built, and :class:`~dist_svgd_torch.ops.kernels.AdaptiveRBF`
(``kernel='median_step'``) is refused for ``'rff'`` at the default
``rff_redraw='run'`` — a bank drawn once at a frozen bandwidth would be
silently decalibrated by per-step drift.  ``rff_redraw='step'`` draws a
fresh bank every step from the stream of ``(bank seed, t)``
(:func:`~dist_svgd_torch.utils.rng.approx_bank_generator`), so under the
rescaling identity each step's bandwidth-1 bank estimates that step's own
median-bandwidth kernel.  Such a φ carries ``needs_step = True`` and the
step builders bind ``t`` through :func:`bind_phi_step`, at the spot where
the minibatch stream is keyed by ``(seed, t)``.  ``'nystrom'`` composes
with the adaptive bandwidth through the exact rescaling identity.

The bank streams are the port's own: JAX draws its bank from threefry,
which no torch stream reproduces.  A private seam
(:attr:`KernelApprox._bank_seam`, ``fn(t, shape, bandwidth) -> bank``)
lets a test hand JAX's banks to the port, as ``_batch_index_seam`` does for
minibatches.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from dist_svgd_torch.ops.kernels import RBF, median_bandwidth, squared_distances
from dist_svgd_torch.utils.rng import approx_bank_generator, init_particles

APPROX_METHODS = ("rff", "nystrom")

#: RFF bank lifetimes: one bank a run, or a fresh bank every step.
RFF_REDRAW_MODES = ("run", "step")

#: ``state_dict`` encoding of the approximation method (an index).
APPROX_METHOD_CODES = APPROX_METHODS

#: ``'auto'`` crossover factor: the approximate φ is preferred once the
#: exact pair count ``k·m`` reaches ``factor × (k+m) × F`` feature
#: evaluations (F = 2·num_features for RFF — the cos and sin banks — and
#: num_landmarks for Nyström).  JAX's formula; the constant is the card's,
#: measured by ``chip_smoke.py``'s ``approx_crossover`` ladder on an NVIDIA
#: H100 80GB HBM3 at a 700.00 W power limit: the exact φ (``phi_small_d``)
#: against ``phi_rff`` and ``phi_nystrom`` at k = m = n, d = 3, R = L in
#: {2048, 4096}, n = 8,192 … 262,144.  A method counts as faster at a rung
#: only where it beats the exact φ by more than 5%, and 'auto' may switch a
#: method (at n = 2·factor·F) only at or above the first rung of its wins
#: up to the top: the switch never lands in an unmeasured gap below a win.
#: Only RFF at R = 2048 won, at n = 262,144 (25.9–26.0 against 30.5–30.6
#: ms): that allows 32.  Nyström at L = 2048 came within 1–3.2% of the
#: exact φ there (29.6–30.2 ms), not a measured win, so its switch at
#: 2·factor·2048 must lie above the ladder: the factor must exceed 64, and
#: 65 is the smallest integer that does.  'auto' then stays exact on the whole ladder; one
#: factor serves both methods (JAX's formula), so RFF's win at 262,144 is
#: taken only with ``'torch'``.  (JAX's 1.0 was set from CPU walls.)
APPROX_CROSSOVER_FACTOR = 65.0

#: ``phi_rff`` builds its (rows, R) feature blocks this many elements at a
#: time at most (4 GB in float32): a memory rule, not a timing.  Below it
#: one block holds every row, the arithmetic of the unblocked form; above it
#: the interaction set's summaries are summed block by block and the
#: updated rows are mapped a block at a time.  Eager PyTorch materialises
#: each feature block (JAX's XLA fuses them), so without blocks the
#: ``large_n_approx`` row at n = 2,000,000, R = 4096 asks for three
#: 32 GB blocks at once and runs the 80 GB card out of memory.
RFF_BLOCK_ELEMS = 1 << 30


class KernelApprox:
    """Static configuration of a sub-quadratic φ approximation.

    Args:
        method: ``'rff'`` or ``'nystrom'``.
        num_features: RFF frequency count R (the bank holds R cos + R sin
            features).  The accuracy dial: φ error ~O(1/√R).
        num_landmarks: Nyström landmark count L (strided from each call's
            interaction set).  Exact at L = m.
        ridge: Tikhonov jitter on the (L, L) landmark system, keeping the
            Cholesky factor well-posed in float32 (JAX's default).
        seed: the bank stream's seed
            (:func:`~dist_svgd_torch.utils.rng.approx_bank_seed` of the run
            seed — the port's counterpart of JAX's bank ``key``).  The
            samplers derive it from the run seed; direct
            :func:`~dist_svgd_torch.ops.cuda_svgd.resolve_phi_fn` users must
            supply it for ``'rff'``.
        rff_redraw: ``'run'`` (default — one bank a run, shared by every
            shard and step) or ``'step'`` (a fresh bank every step from the
            stream of ``(seed, t)``; the φ carries ``needs_step = True`` and
            must be bound with :func:`bind_phi_step`).  ``'step'`` is what
            composes with the per-step median bandwidth.
    """

    def __init__(self, method: str, num_features: int = 2048,
                 num_landmarks: int = 1024, ridge: float = 1e-4,
                 seed: Optional[int] = None, rff_redraw: str = "run"):
        if method not in APPROX_METHODS:
            raise ValueError(
                f"unknown kernel_approx method {method!r} "
                f"(expected one of {APPROX_METHODS})")
        if num_features < 1:
            raise ValueError(f"num_features must be >= 1, got {num_features}")
        if num_landmarks < 1:
            raise ValueError(f"num_landmarks must be >= 1, got {num_landmarks}")
        if ridge < 0:
            raise ValueError(f"ridge must be >= 0, got {ridge}")
        if rff_redraw not in RFF_REDRAW_MODES:
            raise ValueError(
                f"unknown rff_redraw {rff_redraw!r} (expected one of {RFF_REDRAW_MODES})")
        if rff_redraw != "run" and method != "rff":
            raise ValueError(
                f"rff_redraw={rff_redraw!r} applies to method='rff' only "
                f"(got method={method!r}: Nyström landmarks re-factor every "
                "call already)")
        self.method = method
        self.num_features = int(num_features)
        self.num_landmarks = int(num_landmarks)
        self.ridge = float(ridge)
        self.seed = None if seed is None else int(seed)
        self.rff_redraw = rff_redraw
        #: Private seam: ``fn(t, shape, bandwidth) -> (R, d)`` float32
        #: frequency bank used instead of the port's draw (``t`` is ``None``
        #: for a run's bank); tests hand JAX's threefry banks through it.
        self._bank_seam = None

    @property
    def feature_count(self) -> int:
        """Per-row feature work F the crossover compares against ``k·m``."""
        return 2 * self.num_features if self.method == "rff" else self.num_landmarks

    @property
    def accuracy_dial(self) -> int:
        """The method's accuracy parameter (R or L)."""
        return self.num_features if self.method == "rff" else self.num_landmarks

    def with_seed(self, seed: Optional[int]) -> "KernelApprox":
        """A copy bound to bank seed ``seed`` (the samplers bind the run's
        bank seed here); the private bank seam travels with it."""
        out = KernelApprox(self.method, self.num_features, self.num_landmarks,
                           self.ridge, seed, self.rff_redraw)
        out._bank_seam = self._bank_seam
        return out

    def cache_token(self):
        """Hashable identity: method, dials, ridge, bank seed, lifetime."""
        return (self.method, self.num_features, self.num_landmarks, self.ridge,
                self.seed, self.rff_redraw)

    def __repr__(self) -> str:  # pragma: no cover
        dial = (f"num_features={self.num_features}" if self.method == "rff"
                else f"num_landmarks={self.num_landmarks}")
        return f"KernelApprox({self.method!r}, {dial})"

    def __eq__(self, other) -> bool:
        return isinstance(other, KernelApprox) and other.cache_token() == self.cache_token()

    def __hash__(self) -> int:
        return hash(self.cache_token())


def as_kernel_approx(spec: Union[None, str, KernelApprox]) -> Optional[KernelApprox]:
    """Normalise the samplers' ``kernel_approx=`` argument: ``None`` passes
    through, the strings ``'rff'``/``'nystrom'`` take the default dials, a
    :class:`KernelApprox` instance is used as-is."""
    if spec is None or isinstance(spec, KernelApprox):
        return spec
    if isinstance(spec, str):
        return KernelApprox(spec)
    raise ValueError(
        f"kernel_approx must be None, 'rff', 'nystrom', or a KernelApprox "
        f"instance, got {spec!r}")


def is_gram_free(phi_impl, approx_active: bool) -> bool:
    """Whether the resolved φ backend avoids materialising the n×n Gram
    matrix in device memory: true for the hand kernels (``'cuda*'``, whose
    Gram tiles live on chip) and for an *active* approximation; the plain
    φ of ``'torch'`` builds ``(m, k)`` blocks and does not declare it."""
    return bool(approx_active) or str(phi_impl).startswith("cuda")


def approx_preferred(k_eff: int, m: int, feature_count: int) -> bool:
    """The ``'auto'`` crossover: approximate once the exact pair count
    reaches the feature work (:data:`APPROX_CROSSOVER_FACTOR`).  ``k_eff``
    is the effective output-row count, every lane's rows together, so 1-
    and 8-shard runs of one problem pick the same backend."""
    return k_eff * m >= APPROX_CROSSOVER_FACTOR * (k_eff + m) * feature_count


def default_error_budget(approx: KernelApprox, d: int) -> float:
    """The relative-φ-error ceiling the small-n pin (and the
    ``large_n_approx`` gate) holds the approximation to, from its dial and
    the feature dimension (JAX's envelopes): RFF ``3.5·√d/√R``, Nyström
    ``2·√d/√L``.  Defined for the **transient** φ of
    :func:`error_pin_probe`; at convergence φ → 0 and any relative
    residual grows without bound while the absolute update shrinks, so a
    gauge reader should trend the raw residual, not alarm on it alone."""
    if approx.method == "rff":
        return 3.5 * math.sqrt(d) / math.sqrt(approx.num_features)
    return 2.0 * math.sqrt(d) / math.sqrt(approx.num_landmarks)


def error_pin_probe(n: int, d: int, seed: int = 0, dtype: torch.dtype = torch.float32,
                    device=None):
    """The canonical small-n configuration the error budget is pinned on: a
    broad, off-center ensemble (``2.5·N(0,1) + 1.5``, the port's draw of
    ``seed``) against a standard-normal target score — the transient regime
    where φ is O(1) mass transport.  Returns ``(particles, scores, kernel)``
    with the kernel at the probe's own median-heuristic bandwidth.
    ``device=None`` is the card (raising without CUDA)."""
    from dist_svgd_torch.utils.platform import resolve_device

    x = 2.5 * init_particles(seed, n, d, dtype=dtype, device=resolve_device(device)) + 1.5
    return x, -x, RBF(float(median_bandwidth(x)))


# --------------------------------------------------------------------- #
# random Fourier features


def rff_frequencies(generator: torch.Generator, num_features: int, d: int, bandwidth: float,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The shared frequency bank ``W`` (R, d) on the generator's device:
    iid ``N(0, (2/h)·I)`` rows, the spectral measure of ``exp(-‖δ‖²/h)``,
    drawn from ``generator`` alone."""
    base = torch.randn((num_features, d), generator=generator, dtype=dtype,
                       device=generator.device)
    return _scale_bank(base, bandwidth)


def _scale_bank(base: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """``base · √(2/h)`` with the factor rounded to the bank's dtype first
    (JAX multiplies its float32 draw by the factor as a float32)."""
    return base * torch.tensor(float(np.sqrt(2.0 / float(bandwidth))), dtype=base.dtype,
                               device=base.device)


def _bank(approx: KernelApprox, d: int, bandwidth: float, device: torch.device,
          t: Optional[int] = None) -> torch.Tensor:
    """Bank ``(R, d)`` float32 on ``device``: the run's (``t=None``, drawn on
    the CPU) or step ``t``'s (drawn on ``device``), from the private seam
    when one is set."""
    if approx._bank_seam is not None:
        bank = np.array(approx._bank_seam(t, (approx.num_features, d), float(bandwidth)),
                        dtype=np.float32)
        return torch.from_numpy(bank).to(device)
    gen = approx_bank_generator(approx.seed, t, device=device)
    return rff_frequencies(gen, approx.num_features, d, bandwidth).to(device)


def phi_rff(updated: torch.Tensor, interacting: torch.Tensor, scores: torch.Tensor,
            freqs: torch.Tensor) -> torch.Tensor:
    """Feature-space φ̂* — drop-in for ``ops.svgd.phi`` at O((m+k)·R·d).

    With ``Φ(x) = R^{-1/2}[cos(Wx); sin(Wx)]``:

    - drive  ``Σ_j k̂(x_j, y)·s_j = Φ(y)ᵀ(Φ(X)ᵀS)`` — the ``(2R, d)``
      summary is computed once over the interaction set;
    - repulse ``Σ_j ∇_{x_j}k̂(x_j, y) = (1/R)·[sin(Wy)⊙Σcos − cos(Wy)⊙Σsin]·W``
      — the analytic feature gradient summed over the set.

    Leading dimensions broadcast as in ``ops.svgd.phi``.  Never builds an
    (m, k) tensor; the largest temporaries are the feature blocks, at most
    :data:`RFF_BLOCK_ELEMS` elements each (one block at most sizes: the
    unblocked arithmetic)."""
    m = interacting.shape[-2]
    num_features = freqs.shape[0]
    w = freqs.to(torch.promote_types(updated.dtype, torch.float32))
    wt = w.T
    a_cos = a_sin = sum_c = sum_s = None
    for i, j in _row_blocks(interacting, num_features):
        xw = torch.matmul(interacting[..., i:j, :], wt)   # (..., rows, R)
        cx, sx = torch.cos(xw), torch.sin(xw)
        del xw
        s = scores[..., i:j, :]
        parts = (torch.matmul(cx.transpose(-1, -2), s),   # (..., R, d)
                 torch.matmul(sx.transpose(-1, -2), s),
                 torch.sum(cx, dim=-2), torch.sum(sx, dim=-2))  # (..., R)
        del cx, sx
        if a_cos is None:
            a_cos, a_sin, sum_c, sum_s = parts
        else:
            a_cos, a_sin, sum_c, sum_s = (a + b for a, b in zip((a_cos, a_sin, sum_c, sum_s),
                                                                parts))
    sum_c, sum_s = sum_c[..., None, :], sum_s[..., None, :]   # (..., 1, R)
    out = []
    for i, j in _row_blocks(updated, num_features):
        yw = torch.matmul(updated[..., i:j, :], wt)       # (..., rows, R)
        cy, sy = torch.cos(yw), torch.sin(yw)
        del yw
        drive = torch.matmul(cy, a_cos) + torch.matmul(sy, a_sin)
        repulse = torch.matmul(sy * sum_c - cy * sum_s, w)
        out.append((drive + repulse) / (num_features * m))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-2)


def _row_blocks(a: torch.Tensor, num_features: int):
    """``(start, stop)`` row ranges of ``a`` (..., rows, d) whose (..., rows,
    R) feature blocks hold at most :data:`RFF_BLOCK_ELEMS` elements."""
    rows = a.shape[-2]
    lanes = a.numel() // max(rows * a.shape[-1], 1) if a.numel() else 1
    per_block = max(1, RFF_BLOCK_ELEMS // max(lanes * num_features, 1))
    return [(i, min(i + per_block, rows)) for i in range(0, rows, per_block)] or [(0, 0)]


# --------------------------------------------------------------------- #
# Nyström landmarks


def nystrom_landmark_indices(m: int, num_landmarks: int) -> np.ndarray:
    """Evenly-strided landmark indices into an ``m``-row interaction set —
    the ceil-stride subsample of ``median_bandwidth`` (deterministic, no
    carried state).  At ``L ≥ m`` every row is a landmark."""
    if num_landmarks >= m:
        return np.arange(m)
    stride = -(-m // num_landmarks)  # ceil: at most num_landmarks rows
    return np.arange(0, m, stride)


def phi_nystrom(updated: torch.Tensor, interacting: torch.Tensor, scores: torch.Tensor,
                bandwidth: float, num_landmarks: int, ridge: float = 1e-4) -> torch.Tensor:
    """Landmark-factored φ̂* — drop-in for ``ops.svgd.phi`` at
    O(n·L·d + L³).

    Landmarks Z are the strided rows of THIS call's interaction set (each
    lane's own).  Both φ terms route through one Cholesky factor of
    ``K_ZZ + λI``:

    - drive  ``k(y, Z)·(K_ZZ+λI)⁻¹·(K_XZᵀ S)``;
    - repulse ``k(y, Z)·(K_ZZ+λI)⁻¹·G`` with ``G_l = Σ_j ∇_{x_j}k(x_j, z_l)
      = -(2/h)(K_XZᵀX − diag(colsum)·Z)_l``.

    A factor that fails (``cholesky_ex``'s status ≠ 0) is NaN, decided on
    the device."""
    m = interacting.shape[-2]
    # the rows of nystrom_landmark_indices, as a strided view: no index
    # tensor to copy to the device on every call
    stride = 1 if num_landmarks >= m else -(-m // num_landmarks)
    z = interacting[..., ::stride, :]                           # (..., L, d)
    inv_h = 1.0 / float(bandwidth)
    eye = torch.eye(z.shape[-2], dtype=z.dtype, device=z.device)
    kzz = torch.exp(-squared_distances(z, z) * inv_h) + ridge * eye
    kxz = torch.exp(-squared_distances(interacting, z) * inv_h)  # (..., m, L)
    kyz = torch.exp(-squared_distances(updated, z) * inv_h)      # (..., k, L)
    factor, info = torch.linalg.cholesky_ex(kzz)
    factor = torch.where((info == 0)[..., None, None], factor,
                         torch.full_like(factor, float("nan")))
    kxz_t = kxz.transpose(-1, -2)
    drive_c = torch.cholesky_solve(torch.matmul(kxz_t, scores), factor)   # (..., L, d)
    colsum = torch.sum(kxz, dim=-2)                                       # (..., L)
    grad_sum = -(2.0 * inv_h) * (torch.matmul(kxz_t, interacting) - colsum[..., None] * z)
    rep_c = torch.cholesky_solve(grad_sum, factor)
    return torch.matmul(kyz, drive_c + rep_c) / m


# --------------------------------------------------------------------- #
# φ-backend construction (the resolve_phi_fn plug-in)


def bind_phi_step(phi_fn, t):
    """Bind the absolute step index ``t`` into a redraw-per-step φ
    (``phi_fn.needs_step``); the φ itself for every other backend."""
    if getattr(phi_fn, "needs_step", False):
        return lambda y, x, s: phi_fn(y, x, s, t=t)
    return phi_fn


def make_approx_phi_fn(kernel: RBF, approx: KernelApprox):
    """The approximate ``phi_fn(updated, interacting, scores)`` for a
    fixed-bandwidth RBF kernel.  A run's RFF bank is drawn at the first call
    for each feature dimension and device, and reused by every shard, lane
    and step; Nyström needs no bank.

    ``rff_redraw='step'`` instead returns a φ with ``needs_step = True``
    whose signature is ``phi_fn(updated, interacting, scores, t=...)``:
    each call draws step ``t``'s bank on the tensors' device.  Bind the
    step index with :func:`bind_phi_step`."""
    if not isinstance(kernel, RBF):
        raise ValueError(
            "kernel_approx requires an RBF kernel (the feature and landmark "
            f"closed forms are RBF-specific), got {kernel!r}")
    bw = kernel.bandwidth
    if approx.method == "nystrom":
        num_l, ridge = approx.num_landmarks, approx.ridge

        def nystrom_fn(y, x, s):
            return phi_nystrom(y, x, s, bw, num_l, ridge)

        return nystrom_fn
    if approx.seed is None and approx._bank_seam is None:
        raise ValueError(
            "kernel_approx='rff' needs the bank seed: bind one with "
            "KernelApprox.with_seed(utils.rng.approx_bank_seed(seed)) — the "
            "samplers derive it from the run seed automatically")
    if approx.rff_redraw == "step":

        def rff_step_fn(y, x, s, t=None):
            if t is None:
                raise ValueError(
                    "rff_redraw='step' needs the step index: bind it with "
                    "ops.approx.bind_phi_step(phi_fn, t) before calling")
            return phi_rff(y, x, s, _bank(approx, x.shape[-1], bw, x.device, int(t)))

        rff_step_fn.needs_step = True
        return rff_step_fn
    banks = {}

    def rff_fn(y, x, s):
        key = (x.shape[-1], x.device)
        freqs = banks.get(key)
        if freqs is None:
            freqs = banks[key] = _bank(approx, x.shape[-1], bw, x.device)
        return phi_rff(y, x, s, freqs)

    return rff_fn


# --------------------------------------------------------------------- #
# residual probe + gauges (the svgd_diag_* posterior-health channel)


def phi_rel_error(exact, approx) -> float:
    """Global relative L2 (Frobenius) error of an approximate φ against the
    exact one — the single number the error budget bounds (in float64 on
    the host)."""
    def host(a):
        return (a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a, dtype=np.float64))

    exact, approx = host(exact), host(approx)
    denom = float(np.linalg.norm(exact))
    return float(np.linalg.norm(approx - exact) / max(denom, 1e-30))


def phi_residual_report(particles: torch.Tensor, scores: torch.Tensor, kernel: RBF,
                        approx: KernelApprox, max_points: int = 512, step: int = 0) -> dict:
    """The φ residual on an evenly-strided subsample of the ensemble: the
    exact φ (``ops.svgd.phi``) against the configured approximation, both
    over the same ≤ ``max_points`` rows, on the tensors' device.

    Returns ``{phi_approx_rel_err, phi_approx_budget,
    phi_approx_within_budget, phi_approx_dial, n_eval}`` — plain floats,
    gauge-ready.  A redraw-per-step spec probes the bank of ``step``."""
    from dist_svgd_torch.ops.svgd import phi as phi_exact

    n = particles.shape[0]
    if n > max_points:
        stride = -(-n // max_points)
        particles = particles[::stride]
        scores = scores[::stride]
    approx_fn = bind_phi_step(make_approx_phi_fn(kernel, approx), step)
    with torch.no_grad():
        exact = phi_exact(particles, particles, scores, kernel)
        est = approx_fn(particles, particles, scores)
    err = phi_rel_error(exact, est)
    budget = default_error_budget(approx, int(particles.shape[1]))
    return {
        "phi_approx_rel_err": err,
        "phi_approx_budget": budget,
        "phi_approx_within_budget": float(err <= budget),
        "phi_approx_dial": float(approx.accuracy_dial),
        "n_eval": int(particles.shape[0]),
    }


def record_phi_residual(report: dict, registry=None) -> None:
    """Publish a :func:`phi_residual_report` as ``svgd_diag_*`` gauges (a
    ``svgd_diag_phi_approx_within_budget`` gauge at 0 is the alarm; the
    raw residual rides alongside for trending) and count the probe."""
    from dist_svgd_torch.telemetry import metrics as _metrics

    reg = registry if registry is not None else _metrics.default_registry()
    helps = {
        "phi_approx_rel_err":
            "relative L2 error of the approximate phi vs exact (subsample)",
        "phi_approx_budget": "declared approximation error ceiling",
        "phi_approx_within_budget": "1 when the residual is inside budget",
        "phi_approx_dial": "accuracy dial (RFF features / landmarks)",
    }
    for name, help_text in helps.items():
        reg.gauge(f"svgd_diag_{name}", help_text).set(report[name])
    reg.counter("svgd_diag_phi_residual_total",
                "approximation residual probes completed").inc()
