"""Posterior health diagnostics on the device: KSD, kernel ESS, collapse and
shard-divergence indicators.

Counterpart of ``dist_svgd_tpu/telemetry/diagnostics.py``.  SVGD with a
fixed-bandwidth RBF kernel can fail silently in ways no NaN check sees:
particles collapse onto each other, the trajectory stalls far from the
target, or shards drift apart while each looks locally fine.  These are
cheap statistics of the particle tensor already on the device:

- **Kernelized Stein discrepancy** (Liu, Lee & Jordan 2016): the
  U-statistic ``KSD² = 1/(n(n−1)) Σ_{i≠j} u_p(x_i, x_j)`` with the RBF
  ``k(x,y) = exp(−‖x−y‖²/h)`` expanded in closed form (``β = 2/h``)::

      u_p(x,y) = k(x,y)·[ ⟨s_x,s_y⟩ + β⟨s_x−s_y, x−y⟩ + βd − β²‖x−y‖² ]

  where ``s_x = ∇log p(x)``; no ``(n, n, d)`` tensor is built.
- **Kernel-matrix effective sample size**: ``ESS = n² / Σᵢⱼ Kᵢⱼ²`` — ``n``
  for well-spread particles, 1 for a fully collapsed set.  Score-free, so
  it also guards a serving-side reload (:class:`ReloadPolicy`).
- **Collapse indicators**: min pairwise distance (exact over all pairs),
  median pairwise distance (the sort-free counting bracket of
  :func:`dist_svgd_torch.ops.kernels._median_bracket` on a strided
  subsample), and the per-dimension variance floor.
- **Inter-shard divergence** (the samplers' contiguous block layout): max
  over shards of the scale-normalised mean / variance discrepancy between
  a shard's block and the global set.

Everything pairwise is **chunked**: the ``(n, n)`` interaction is a loop
over blocks of ``row_chunk`` rows against the full column set, so the live
memory is ``row_chunk × n``, never ``n²``; the ragged last block holds only
real rows, so the chunked sums are the unchunked ones (JAX pads that block
with rows of weight zero, which add nothing).  The statistics stay on the
tensors' device, and each compute moves them to the host in one transfer.

Results flow into the :class:`~dist_svgd_torch.telemetry.metrics.
MetricsRegistry` as ``svgd_diag_*`` gauges, run inside ``train.diagnostics``
spans while the tracer is enabled, and are handed to the flight recorder.
When disabled a caller holds the shared no-op singleton (:data:`DISABLED`):
no allocation, no clock read.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from dist_svgd_torch.ops.kernels import _median_bracket, median_bandwidth_approx, squared_distances
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.utils.platform import pin_full_f32

__all__ = [
    "DiagnosticsConfig",
    "PosteriorDiagnostics",
    "ReloadPolicy",
    "InputScore",
    "data_score",
    "DISABLED",
    "ensemble_health",
]


def _scan_pair_blocks(particles: torch.Tensor, scores: Optional[torch.Tensor], h,
                      row_chunk: int):
    """One chunked pass over the ``(n, n)`` pairwise interaction.

    Returns ``(sum_u, sum_k2, min_offdiag_sq)`` as 0-dim tensors: ``sum_u``
    is the all-pairs (diagonal included) Stein-kernel sum — ``None`` when
    ``scores`` is ``None`` — and the other two are score-free.  Rows go in
    blocks of ``row_chunk`` against the full column set."""
    n, d = particles.shape
    beta = 2.0 / h
    c = max(1, min(int(row_chunk), n))
    cols = torch.arange(n, device=particles.device)
    with_u = scores is not None
    if with_u:
        s_dot_x_cols = torch.sum(scores * particles, dim=-1)  # (n,)
        sum_u = particles.new_zeros(())
    sum_k2 = particles.new_zeros(())
    min_sq = particles.new_full((), float("inf"))
    for r0 in range(0, n, c):
        xb = particles[r0:r0 + c]
        sq = squared_distances(xb, particles)  # (c, n)
        k = torch.exp(-sq / h)
        sum_k2 = sum_k2 + torch.sum(k * k)
        if with_u:
            sb = scores[r0:r0 + c]
            ss = torch.matmul(sb, scores.T)
            sxr = torch.sum(sb * xb, dim=-1)[:, None] - torch.matmul(sb, particles.T)
            syr = torch.matmul(xb, scores.T) - s_dot_x_cols[None, :]
            u = k * (ss + beta * (sxr - syr) + beta * d - beta * beta * sq)
            sum_u = sum_u + torch.sum(u)
        rows = r0 + torch.arange(xb.shape[0], device=particles.device)
        diag = cols[None, :] == rows[:, None]
        min_sq = torch.minimum(min_sq, torch.min(sq.masked_fill(diag, float("inf"))))
    return (sum_u if with_u else None), sum_k2, min_sq


def _resolve_bandwidth(particles: torch.Tensor, bandwidth: float, median_bw: bool):
    if median_bw:
        return median_bandwidth_approx(particles)
    # a fill, not a host copy: the pass may run inside a graph capture
    return particles.new_full((), float(bandwidth))


#: Row cap for the median-distance bracket inside the pairwise pass — the
#: bracket's four broadcast-compare passes dominate everything else above
#: this, and a median order statistic stabilises far below it.
MEDIAN_DIST_POINTS = 256


def _median_dist(particles: torch.Tensor) -> torch.Tensor:
    """Median pairwise distance over a further-capped strided slice: the
    sort-free counting bracket at 8 probes (resolution 8⁻⁴ of the distance
    range)."""
    p0 = particles.shape[0]
    if p0 > MEDIAN_DIST_POINTS:
        particles = particles[::-(-p0 // MEDIAN_DIST_POINTS)]
    p = particles.shape[0]
    sq = squared_distances(particles, particles)
    # the p diagonal zeros are below any positive threshold: add them to
    # the target rank instead of masking (median_bandwidth_approx's trick)
    target = p + (p * p - p + 1) // 2
    return torch.sqrt(_median_bracket(sq, target, 8))


def _ksd_stats(particles: torch.Tensor, scores: torch.Tensor, bandwidth: float,
               row_chunk: int, median_bw: bool) -> Dict[str, torch.Tensor]:
    """KSD² (U-statistic) + kernel ESS + min/median pairwise distance, as
    0-dim tensors on the particles' device."""
    n, d = particles.shape
    h = _resolve_bandwidth(particles, bandwidth, median_bw)
    sum_u, sum_k2, min_sq = _scan_pair_blocks(particles, scores, h, row_chunk)
    beta = 2.0 / h
    diag_u = torch.sum(scores * scores) + n * beta * d  # u(x, x) summed
    ksd_sq = (sum_u - diag_u) / (n * (n - 1))
    return {
        "ksd_sq": ksd_sq,
        "ksd": torch.sqrt(torch.clamp(ksd_sq, min=0.0)),
        "ess": (n * n) / sum_k2,
        "min_pairwise_dist": torch.sqrt(min_sq),
        "median_pairwise_dist": _median_dist(particles),
        "bandwidth": h,
    }


def _kernel_stats(particles: torch.Tensor, bandwidth: float, row_chunk: int,
                  median_bw: bool) -> Dict[str, torch.Tensor]:
    """Score-free twin of :func:`_ksd_stats` (no KSD term)."""
    n = particles.shape[0]
    h = _resolve_bandwidth(particles, bandwidth, median_bw)
    _, sum_k2, min_sq = _scan_pair_blocks(particles, None, h, row_chunk)
    return {
        "ess": (n * n) / sum_k2,
        "min_pairwise_dist": torch.sqrt(min_sq),
        "median_pairwise_dist": _median_dist(particles),
        "bandwidth": h,
    }


def _dim_var_stats(particles: torch.Tensor) -> torch.Tensor:
    """Per-dimension variance floor — O(nd), over the full set (population
    variance, as ``jnp.var``)."""
    return torch.min(torch.var(particles, dim=0, correction=0))


def _shard_stats(particles: torch.Tensor, num_shards: int) -> Dict[str, torch.Tensor]:
    """Scale-normalised divergence of each contiguous shard block from the
    global particle set (shard s owns rows ``[s·per, (s+1)·per)``); the
    variance floor rides along."""
    n, d = particles.shape
    blocks = particles.reshape(num_shards, n // num_shards, d)
    mu = torch.mean(blocks, dim=1)                   # (S, d)
    var = torch.var(blocks, dim=1, correction=0)     # (S, d)
    gmu = torch.mean(particles, dim=0)
    gvar = torch.var(particles, dim=0, correction=0)
    scale = torch.sqrt(torch.sum(gvar)) + 1e-12
    return {
        "shard_mean_div": torch.max(torch.linalg.vector_norm(mu - gmu[None, :], dim=1)) / scale,
        "shard_var_div": torch.max(torch.linalg.vector_norm(var - gvar[None, :], dim=1))
        / (torch.sum(gvar) + 1e-12),
        "min_dim_var": torch.min(gvar),
    }


def _subsample(particles: torch.Tensor, max_points: int) -> torch.Tensor:
    """Evenly-strided row subsample of at most ``max_points`` rows (an
    O(n²) statistic over more rows costs more than the step it observes)."""
    n = particles.shape[0]
    if n > max_points:
        particles = particles[::-(-n // max_points)]
    return particles


def _host_floats(block: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Every 0-dim tensor of ``block`` as a Python float, in one device →
    host transfer (it is the compute's fence)."""
    keys = list(block)
    return dict(zip(keys, _stacked(block).tolist()))


def _stacked(block: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``block``'s 0-dim tensors as one float64 vector, in its key order."""
    return torch.stack([v.to(torch.float64) for v in block.values()])


class InputScore:
    """A score closure ``θ ↦ ∇log p(θ)`` that names the tensors it reads.

    ``fn(theta, *tensors)`` is the score on explicit tensors and
    ``inputs()`` returns the tensors the closure reads now (none by
    default); calling the closure is ``fn(theta, *inputs())``.  On the card
    :class:`PosteriorDiagnostics` replays one captured CUDA graph for such
    a closure and copies what ``inputs()`` returns into the graph's inputs
    at every compute, so data the closure swaps between computes (a
    streaming corpus, a sampler's ``set_data``) is read fresh, never from
    the address the capture saw.  Any other closure runs eagerly."""

    __slots__ = ("fn", "inputs")

    def __init__(self, fn: Callable, inputs: Callable[[], tuple] = tuple):
        self.fn = fn
        self.inputs = inputs

    def __call__(self, theta):
        return self.fn(theta, *self.inputs())


def data_score(data: Callable[[], object],
               score_on: Callable[[object], Callable]) -> InputScore:
    """An :class:`InputScore` over a data tree: ``data()`` returns the tree
    the closure reads now (``None``, a tensor, or a tuple / list / dict of
    them) and ``score_on(tree)`` the score ``θ ↦ ∇log p(θ)`` on it.  The
    tree's tensors are the closure's inputs."""
    from dist_svgd_torch.parallel.exchange import tree_map

    latest = [None]  # the tree of the newest data() call: its structure

    def inputs():
        tree = latest[0] = data()
        leaves = []
        tree_map(leaves.append, tree)
        return tuple(leaves)

    def fn(theta, *leaves):
        it = iter(leaves)
        return score_on(tree_map(lambda _: next(it), latest[0]))(theta)

    return InputScore(fn, inputs)


@dataclass
class DiagnosticsConfig:
    """What to compute, how often, and at what cost ceiling.

    Args:
        every_steps: compute at step multiples of this.
        bandwidth: RBF bandwidth ``h`` for KSD/ESS — a float, or
            ``'median'`` to re-resolve it by the sort-free median heuristic
            (:func:`~dist_svgd_torch.ops.kernels.median_bandwidth_approx`)
            on every compute.
        row_chunk: pairwise row-block size — live memory is
            ``row_chunk × rows``, never ``rows²``.
        max_points: cap on the rows entering any O(rows²) statistic (KSD,
            ESS, min/median pairwise distance): past it an evenly-strided
            subsample is evaluated instead.  Per-dim variance and shard
            divergence always use the full set (they are O(n·d)).
            ``ess_frac`` is ESS over the *evaluated* rows.
        score_fn: ``θ ↦ ∇log p(θ)`` (one particle, in torch) for the KSD
            term, batched with ``torch.func.vmap``.  ``None`` skips KSD
            (ESS/collapse/shard stats are score-free).
    """

    every_steps: int = 50
    bandwidth: Union[float, str] = 1.0
    row_chunk: int = 1024
    max_points: int = 1024
    score_fn: Optional[Callable] = field(default=None, repr=False)

    def __post_init__(self):
        if self.every_steps < 1:
            raise ValueError(f"every_steps must be >= 1, got {self.every_steps}")
        if self.bandwidth != "median" and not float(self.bandwidth) > 0:
            raise ValueError(f"bandwidth must be positive or 'median', got {self.bandwidth}")
        if self.row_chunk < 1:
            raise ValueError(f"row_chunk must be >= 1, got {self.row_chunk}")
        if self.max_points < 2:
            raise ValueError(f"max_points must be >= 2, got {self.max_points}")


def _capture(fn: Callable, args: list):
    """The pass's program for one key: a captured CUDA graph on the card
    (``parallel/plan.py:_Graph``, as the serving programs), ``None`` on the
    CPU, where the pass runs eagerly."""
    device = args[0].device
    if device.type != "cuda":
        return None
    from dist_svgd_torch.parallel import plan

    return plan._Graph(fn, args, device, plan.WARMUP_CALLS)


class _NoopDiagnostics:
    """Disabled-path singleton: the per-boundary check is one attribute
    load and a constant-returning method — no allocation, no clock read."""

    __slots__ = ()
    enabled = False
    last_report = None

    def should_run(self, t):
        return False

    def compute(self, particles, scores=None, num_shards=None, step=None):
        return None

    def ensure_score_fn(self, score_fn):
        return self


#: Shared no-op instance — what a caller holds when diagnostics are off.
DISABLED = _NoopDiagnostics()


class PosteriorDiagnostics:
    """Computes, records, and remembers the posterior health statistics.

    Args:
        config: :class:`DiagnosticsConfig` (default: defaults above).
        registry: metrics registry for the ``svgd_diag_*`` gauges, the
            computation counter, and the compute-wall histogram (default:
            the process-wide registry).
        logger: optional ``JsonlLogger`` — one record per computation.
        wall_clock: unix-time source for the freshness gauge
            (``svgd_diag_last_update_ts`` — what a staleness SLO reads).

    Every computation runs inside a ``train.diagnostics`` span (tagged with
    step and n) while the tracer is enabled, and is handed to the installed
    flight recorder.
    """

    enabled = True

    def __init__(self, config: Optional[DiagnosticsConfig] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 logger=None, wall_clock: Callable[[], float] = time.time):
        self.config = config or DiagnosticsConfig()
        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        self._logger = logger
        self._wall_clock = wall_clock
        # instance-held score closure: ensure_score_fn adopts a sampler's
        # closure here, never into the caller-owned (possibly shared) config
        self._score_fn = self.config.score_fn
        # the pass's programs by key (_pass_key): a captured graph on the
        # card, None on the CPU (the key's first compute is still counted)
        self._graphs: Dict[tuple, object] = {}
        self._graph_lock = threading.Lock()
        self._gauges = {
            name: reg.gauge(f"svgd_diag_{name}", help)
            for name, help in (
                ("ksd", "kernelized Stein discrepancy (U-statistic sqrt)"),
                ("ess", "kernel-matrix effective sample size"),
                ("ess_frac", "kernel ESS over particle count"),
                ("min_pairwise_dist", "smallest inter-particle distance"),
                ("median_pairwise_dist",
                 "median inter-particle distance (strided subsample)"),
                ("min_dim_var", "smallest per-dimension particle variance"),
                ("shard_mean_div",
                 "max scale-normalised shard-mean divergence"),
                ("shard_var_div",
                 "max normalised shard-variance divergence"),
                ("last_step", "step of the newest diagnostics computation"),
                ("last_update_ts",
                 "unix time of the newest diagnostics computation"),
            )
        }
        self._m_computations = reg.counter(
            "svgd_diag_computations_total", "diagnostics passes completed")
        self._m_wall = reg.histogram(
            "svgd_diag_compute_seconds", "wall per diagnostics pass")
        #: Most recent report dict (plain floats), ``None`` before any.
        self.last_report: Optional[Dict] = None

    def should_run(self, t: int) -> bool:
        """True when step ``t`` is on the cadence grid (t > 0)."""
        return t > 0 and t % self.config.every_steps == 0

    def ensure_score_fn(self, score_fn: Optional[Callable]) -> "PosteriorDiagnostics":
        """Adopt ``score_fn`` if this instance has none.  Instance-scoped:
        the shared config object is never mutated."""
        if self._score_fn is None and score_fn is not None:
            self._score_fn = score_fn
        return self

    def compute(self, particles, scores=None, num_shards: Optional[int] = None,
                step: Optional[int] = None) -> Dict:
        """One full diagnostics pass over ``particles`` (``(n, d)``, on any
        device; the statistics run there).

        ``scores`` overrides the config's ``score_fn`` (pass the score
        tensor a training step already computed); ``num_shards`` > 1 adds
        the inter-shard divergence block.  Returns the report dict of
        plain floats (also kept as :attr:`last_report`).

        On the card the pass is one CUDA graph a key — the shapes, the
        shard count, the config's ``max_points`` / ``row_chunk`` /
        ``bandwidth`` and the score closure — captured at the key's first
        compute (``parallel/plan.py:capture_sentry`` counts it) and
        replayed after, with one host transfer; JAX compiles its pass once
        the same way.  That holds when the pass reads nothing a graph could
        bake in: passed ``scores``, no score, or an :class:`InputScore`,
        whose tensors are graph inputs.  Any other score closure runs the
        pass eagerly, as on the CPU."""
        cfg = self.config
        particles = torch.as_tensor(particles)
        n, d = particles.shape
        if n < 2:
            raise ValueError(f"diagnostics need n >= 2 particles, got {n}")
        if particles.device.type == "cuda":
            pin_full_f32()
        t0 = time.perf_counter()
        traced = _trace.enabled()
        # torch.func.grad in the score closure ignores an outer no_grad
        with _trace.span("train.diagnostics", {"step": step, "n": n} if traced else None), \
                torch.no_grad():
            shards = (num_shards if num_shards and num_shards > 1 and n % num_shards == 0
                      else 1)
            score = None if scores is not None else self._score_fn
            args = [particles]
            if scores is not None:
                args.append(torch.as_tensor(scores, device=particles.device))
            elif isinstance(score, InputScore):
                args.extend(score.inputs())
            keys = []
            fn = self._pass_fn(cfg, score, scores is not None, shards, keys)
            if score is None or isinstance(score, InputScore):
                vec, keys = self._graphed(fn, args, keys,
                                          self._pass_key(cfg, score, shards, args))
            else:
                vec = fn(*args)
            # the one host transfer is the fence: the span's wall covers the
            # device's execution
            report = dict(zip(keys, vec.tolist()))
        n_eval = _subsample(particles, cfg.max_points).shape[0]
        report["ess_frac"] = report["ess"] / n_eval
        report["n"] = n
        report["n_eval"] = n_eval
        report["d"] = d
        if step is not None:
            report["step"] = step
        wall = time.perf_counter() - t0
        report["wall_s"] = round(wall, 6)
        self._record(report, wall)
        return report

    @staticmethod
    def _pass_key(cfg: DiagnosticsConfig, score, shards: int, args) -> tuple:
        return (tuple((tuple(a.shape), a.dtype, a.device) for a in args), shards,
                cfg.max_points, cfg.row_chunk, cfg.bandwidth, score)

    @staticmethod
    def _pass_fn(cfg: DiagnosticsConfig, score, with_scores: bool, shards: int,
                 keys: list) -> Callable:
        """The pass as a function of its tensors — ``(particles[, scores |
        the score's inputs])`` → the report's float64 vector, whose names
        it writes into ``keys``.  Every shape and setting it branches on
        is in the pass's key, so a captured graph of it stays valid."""
        median_bw = cfg.bandwidth == "median"
        bw = 1.0 if median_bw else float(cfg.bandwidth)

        def run(particles, *rest):
            # all O(rows²) statistics run on the capped subsample
            sub = _subsample(particles, cfg.max_points)
            if with_scores:
                sub_scores = _subsample(rest[0], cfg.max_points)
            elif isinstance(score, InputScore):
                sub_scores = torch.func.vmap(lambda th: score.fn(th, *rest))(sub)
            elif score is not None:
                sub_scores = torch.func.vmap(score)(sub)
            else:
                sub_scores = None
            if sub_scores is not None:
                pair = _ksd_stats(sub, sub_scores, bw, cfg.row_chunk, median_bw)
            else:
                pair = _kernel_stats(sub, bw, cfg.row_chunk, median_bw)
            if shards > 1:
                extra = _shard_stats(particles, shards)
            else:
                extra = {"min_dim_var": _dim_var_stats(particles)}
            block = {**pair, **extra}
            keys[:] = list(block)
            return _stacked(block)

        return run

    def _graphed(self, fn: Callable, args: list, keys: list,
                 key: tuple) -> Tuple[torch.Tensor, list]:
        """``fn(*args)`` and its report names through the key's program: a
        CUDA graph on the card (captured by the key's first compute,
        replayed after: the arguments are copied into its static inputs and
        its vector fetched to the host); eagerly on the CPU.  A key's first
        compute counts as one capture on either device, as a new program
        shape does."""
        from dist_svgd_torch.parallel import plan

        with self._graph_lock:
            if key not in self._graphs:
                # the capture's warm-up calls name the vector's entries
                self._graphs[key] = (_capture(fn, args), keys)
                plan._note_capture()
            graph, graph_keys = self._graphs[key]
        if graph is None:
            return fn(*args), keys
        return graph.replay(args), graph_keys

    def _record(self, report: Dict, wall: float) -> None:
        for name, gauge in self._gauges.items():
            if name == "last_step":
                if "step" in report:
                    gauge.set(report["step"])
            elif name == "last_update_ts":
                gauge.set(self._wall_clock())
            elif name in report:
                gauge.set(report[name])
        self._m_computations.inc()
        self._m_wall.observe(wall)
        self.last_report = report
        _trace.record_flight("diagnostics", **report)
        if self._logger is not None:
            self._logger.log(event="diagnostics", **report)


def ensemble_health(particles, max_points: int = 2048,
                    bandwidth: Union[float, str] = "median",
                    row_chunk: int = 1024) -> Dict:
    """Score-free health snapshot of a particle ensemble — the serving
    side's diagnostic (no ∇log p at serve time).

    Evaluates kernel ESS / min distance / variance floor / median distance
    over an evenly-strided subsample of at most ``max_points`` rows (the
    reported ``ess`` is the subsample's; ``ess_frac`` — ESS over evaluated
    rows — is the scale-free number to threshold)."""
    particles = torch.as_tensor(particles)
    if particles.dim() != 2 or particles.shape[0] < 2:
        raise ValueError(
            f"ensemble_health needs an (n>=2, d) array, got {tuple(particles.shape)}")
    if particles.device.type == "cuda":
        pin_full_f32()
    sub = _subsample(particles, max_points)
    median_bw = bandwidth == "median"
    bw = 1.0 if median_bw else float(bandwidth)
    with torch.no_grad():
        report = _host_floats({**_kernel_stats(sub, bw, row_chunk, median_bw),
                               "min_dim_var": _dim_var_stats(particles)})
    report["n_eval"] = int(sub.shape[0])
    report["ess_frac"] = report["ess"] / sub.shape[0]
    return report


class ReloadPolicy:
    """Serve-side admission check: reject a candidate ensemble whose
    health regressed past thresholds.

    All checks are score-free (:func:`ensemble_health`); absolute floors
    apply always, relative checks compare against the currently-served
    ensemble's report.  A ``None`` threshold disables that check.

    Args:
        min_ess_frac: absolute floor on ``ess_frac`` (collapse filter).
        max_ess_drop_frac: max allowed *relative* ESS-fraction drop vs the
            served baseline (0.5 = reject below half the baseline).
        min_dim_var: absolute floor on the per-dimension variance minimum.
        max_points / bandwidth / row_chunk: forwarded to
            :func:`ensemble_health`.
    """

    def __init__(self, min_ess_frac: Optional[float] = 0.01,
                 max_ess_drop_frac: Optional[float] = 0.5,
                 min_dim_var: Optional[float] = None,
                 max_points: int = 2048,
                 bandwidth: Union[float, str] = "median",
                 row_chunk: int = 1024):
        self.min_ess_frac = min_ess_frac
        self.max_ess_drop_frac = max_ess_drop_frac
        self.min_dim_var = min_dim_var
        self.max_points = int(max_points)
        self.bandwidth = bandwidth
        self.row_chunk = int(row_chunk)

    def evaluate(self, particles) -> Dict:
        return ensemble_health(particles, max_points=self.max_points,
                               bandwidth=self.bandwidth, row_chunk=self.row_chunk)

    def judge(self, candidate: Dict, baseline: Optional[Dict]) -> list:
        """Reasons the candidate fails (empty list = admit).  ``not <=`` /
        ``not >=`` comparisons so a NaN statistic rejects instead of
        comparing False."""
        reasons = []
        if (self.min_ess_frac is not None
                and not candidate["ess_frac"] >= self.min_ess_frac):
            reasons.append(
                f"ess_frac {candidate['ess_frac']:.4g} below floor "
                f"{self.min_ess_frac:g}")
        if (self.max_ess_drop_frac is not None and baseline is not None
                and baseline.get("ess_frac", 0) > 0):
            floor = baseline["ess_frac"] * (1.0 - self.max_ess_drop_frac)
            if not candidate["ess_frac"] >= floor:
                reasons.append(
                    f"ess_frac {candidate['ess_frac']:.4g} dropped past "
                    f"{self.max_ess_drop_frac:g} of served baseline "
                    f"{baseline['ess_frac']:.4g}")
        if (self.min_dim_var is not None
                and not candidate["min_dim_var"] >= self.min_dim_var):
            reasons.append(
                f"min_dim_var {candidate['min_dim_var']:.4g} below floor "
                f"{self.min_dim_var:g}")
        return reasons
