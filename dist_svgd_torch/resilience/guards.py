"""Numerical health checks on carried sampler state.

Counterpart of ``dist_svgd_tpu/resilience/guards.py``.  SVGD failure modes
that survive a dispatch but poison the trajectory:

- **NaN/Inf contamination** — one non-finite score entry spreads through the
  φ interaction sum to every particle within a step or two (the kernel
  couples all pairs);
- **particle-norm explosion** — a too-large step size on a stiff posterior
  sends particles running down an unbounded likelihood direction;
- **step-size divergence** — per-step displacement growing instead of
  contracting toward the fixed point (Liu & Wang 2016's iteration is a
  contraction near the posterior for small enough ε).

The three checks are one torch pass over the ``(n, d)`` tensor on its own
device, which leaves a 3-vector there; the host reads that vector once
(three scalars), so a supervised run can afford it at every segment
boundary.  The particles themselves never leave the device.  On violation
the supervisor rolls back to the last good checkpoint and backs the step
size off (:class:`~dist_svgd_torch.resilience.supervisor.RunSupervisor`),
logging the report through ``utils/metrics.py:JsonlLogger``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


class GuardViolation(RuntimeError):
    """A numerical health check failed.  ``report`` holds the measured
    scalars (finite counts, norms, displacement) and ``reason`` the check
    that tripped."""

    def __init__(self, reason: str, report: dict):
        super().__init__(f"{reason}: {report}")
        self.reason = reason
        self.report = report


@dataclass
class GuardConfig:
    """What to check, and the recovery knob.

    Args:
        check_finite: trip on any NaN/Inf entry in the particle state.
        max_particle_norm: trip when any particle's L2 norm exceeds this
            (``None`` disables) — the norm-explosion guard.
        max_step_norm: trip when the maximum per-step particle displacement
            across the checked segment exceeds this (``None`` disables) —
            the step-size-divergence guard.  Needs the pre-segment state,
            which the supervisor snapshots only when this is set.
        backoff_factor: step-size multiplier applied on rollback (the
            supervisor's step-size-backoff policy).
        max_ksd: trip when the diagnosed kernelized Stein discrepancy
            exceeds this — the posterior-drift guard.  Evaluated (like the
            three thresholds below) against the supervisor's periodic
            :class:`~dist_svgd_torch.telemetry.diagnostics.
            PosteriorDiagnostics` report, so it only fires on boundaries
            where diagnostics ran (and, for KSD, only when a score
            function is configured).
        min_ess_frac: trip when kernel-ESS over n falls below this — the
            particle-collapse guard (score-free).
        min_dim_var: trip when any dimension's particle variance falls
            below this — the dead-dimension / mode-collapse guard.
        max_shard_mean_div: trip when the scale-normalised inter-shard
            mean divergence exceeds this (``DistSampler`` runs only).
    """

    check_finite: bool = True
    max_particle_norm: Optional[float] = None
    max_step_norm: Optional[float] = None
    backoff_factor: float = 0.5
    max_ksd: Optional[float] = None
    min_ess_frac: Optional[float] = None
    min_dim_var: Optional[float] = None
    max_shard_mean_div: Optional[float] = None

    @property
    def needs_prev(self) -> bool:
        return self.max_step_norm is not None

    @property
    def checks_diagnostics(self) -> bool:
        """True when any drift/collapse threshold is set — the supervisor
        then routes diagnostics reports through :func:`check_diagnostics`."""
        return any(v is not None for v in (
            self.max_ksd, self.min_ess_frac, self.min_dim_var,
            self.max_shard_mean_div,
        ))


def _health(particles: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """One pass on the particles' device: the float64 3-vector (#non-finite
    entries, max particle norm, max row displacement vs ``prev``)."""
    with torch.no_grad():
        nonfinite = particles.numel() - torch.isfinite(particles).sum()
        # a NaN-poisoned norm must still trip max_particle_norm comparisons:
        # torch's max propagates NaN, and the caller checks non-finite first
        max_norm = torch.linalg.vector_norm(particles, dim=-1).max()
        max_delta = torch.linalg.vector_norm(particles - prev, dim=-1).max()
        return torch.stack([nonfinite.to(torch.float64), max_norm.to(torch.float64),
                            max_delta.to(torch.float64)])


def check_state(particles, prev=None, steps: int = 1,
                config: Optional[GuardConfig] = None) -> dict:
    """Run the configured checks on ``particles``; returns the measured
    report dict, raising :class:`GuardViolation` on the first tripped check.

    ``prev`` is the state ``steps`` steps earlier (for the displacement
    guard; defaults to ``particles``, making that guard inert), and the
    reported ``max_step_norm`` is the max row displacement divided by
    ``steps`` — a per-step divergence proxy that stays comparable across
    segment lengths.  The checks run where ``particles`` lies; the host
    reads their three scalars in one transfer."""
    config = config or GuardConfig()
    particles = torch.as_tensor(particles)
    prev_t = particles if prev is None else torch.as_tensor(prev, device=particles.device)
    nonfinite, max_norm, max_delta = _health(particles, prev_t).tolist()
    report = {
        "nonfinite_entries": int(nonfinite),
        "max_particle_norm": float(max_norm),
        "max_step_norm": float(max_delta) / max(int(steps), 1),
    }
    if config.check_finite and report["nonfinite_entries"]:
        raise GuardViolation("non-finite particle state", report)
    if (config.max_particle_norm is not None
            and not report["max_particle_norm"] <= config.max_particle_norm):
        # `not <=` rather than `>`: a NaN norm with check_finite=False must
        # still trip here instead of comparing False
        raise GuardViolation(
            f"particle norm exceeds {config.max_particle_norm}", report
        )
    if (prev is not None and config.max_step_norm is not None
            and not report["max_step_norm"] <= config.max_step_norm):
        raise GuardViolation(
            f"per-step displacement exceeds {config.max_step_norm}", report
        )
    return report


def check_diagnostics(report: dict, config: GuardConfig) -> dict:
    """Judge a posterior-diagnostics report against the drift/collapse
    thresholds; returns ``report``, raising :class:`GuardViolation` on the
    first tripped check.

    ``report`` is a :class:`~dist_svgd_torch.telemetry.diagnostics.
    PosteriorDiagnostics` report dict (plain floats).  A statistic absent
    from the report (e.g. ``ksd`` with no score function, shard divergence
    on a single-device run) leaves its check inert; every comparison is
    the NaN-safe ``not <=`` / ``not >=`` form, so a NaN statistic trips
    instead of comparing False.
    """
    ksd = report.get("ksd")
    if (config.max_ksd is not None and ksd is not None
            and not ksd <= config.max_ksd):
        raise GuardViolation(
            f"posterior drift: ksd exceeds {config.max_ksd}", report)
    ess_frac = report.get("ess_frac")
    if (config.min_ess_frac is not None and ess_frac is not None
            and not ess_frac >= config.min_ess_frac):
        raise GuardViolation(
            f"particle collapse: ess_frac below {config.min_ess_frac}",
            report)
    min_var = report.get("min_dim_var")
    if (config.min_dim_var is not None and min_var is not None
            and not min_var >= config.min_dim_var):
        raise GuardViolation(
            f"dimension collapse: min_dim_var below {config.min_dim_var}",
            report)
    shard_div = report.get("shard_mean_div")
    if (config.max_shard_mean_div is not None and shard_div is not None
            and not shard_div <= config.max_shard_mean_div):
        raise GuardViolation(
            f"shard divergence: shard_mean_div exceeds "
            f"{config.max_shard_mean_div}", report)
    return report
