"""SLO-burn-driven adaptive capacity: the serving control plane.

Counterpart of ``dist_svgd_tpu/serving/autoscale.py``, decision for
decision.  An :class:`AutoscaleController` watches the SLO burn rate and
the queue / latency windows of the shared :class:`~dist_svgd_torch.
telemetry.metrics.MetricsRegistry` and retunes the :class:`~dist_svgd_torch.
serving.batcher.MicroBatcher` live, within bounded hysteresis:

- **lanes** (``MicroBatcher.set_lanes``): more dispatch workers under
  overload — the throughput knob;
- **max_wait_ms** (``MicroBatcher.set_max_wait_ms``): a wider coalescing
  window under overload amortises the per-dispatch floor (on the card, one
  CUDA-graph replay plus the host's copy-in and fetch) over bigger
  batches; a tight window in steady state keeps the latency floor low.
  No single static window is right for both regimes — that asymmetry is
  the controller's whole reason to exist;
- **per-tenant quotas** (``ModelRegistry.set_quota``): tightened under
  overload so hog tenants shed *early* — at admission, before their
  queued work turns into everyone's p99 breach — and restored when calm.

Control discipline:

- signals come from the controller's OWN windowed accessors
  (``telemetry/slo.py``: a second :class:`~dist_svgd_torch.telemetry.slo.
  SloEngine` with ``mirror_metrics=False`` plus ``HistogramWindow`` /
  ``CounterWindow``) so its cadence never advances — or double-counts —
  the ``/slo`` endpoint's objective windows;
- **overload** = burn at/over ``burn_up``, any shed in the window, or
  queue depth over ``queue_high_frac`` of the bound (the *before the
  breach* signal: a growing queue predicts the p99 breach the burn rate
  only confirms afterwards);
- **calm** = burn at/under ``burn_down`` AND no sheds AND a near-empty
  queue, sustained for ``down_consecutive`` control steps — scale-down
  is deliberately slower than scale-up;
- every action respects a per-direction ``cooldown_s`` and the bounded
  ranges; knobs never leave ``[min, max]``, and scale-down stops at the
  construction-time baseline by default.

It is host code and touches no tensor.  Time is injectable (``clock=``)
so every decision path runs deterministically in tests;
:meth:`AutoscaleController.step` is the whole control iteration, and
:meth:`start` runs it on a background cadence.  The HTTP layer serves
:meth:`status` at ``/autoscale``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry.slo import (
    CounterWindow,
    HistogramWindow,
    default_serving_slos,
)

__all__ = ["AutoscalePolicy", "AutoscaleController"]


class AutoscalePolicy:
    """Bounds + hysteresis configuration (static; the controller never
    mutates it).

    Args:
        lanes_max / lanes_min: bounded lane range.  ``lanes_min=None``
            (default) pins the floor at the batcher's construction-time
            lane count — scale-down returns to baseline, never below.
        max_wait_ms_max / max_wait_ms_min: bounded coalescing-window
            range; ``None`` floor = the construction-time window.
        p99_target_ms: the latency objective the controller defends (its
            own SLO engine's ``serve_p99`` threshold).
        burn_up: scale up when the p99 burn rate reaches this (1.0 = the
            error budget's edge — acting at the edge, not past it).
        burn_down: a calm window needs burn at/under this.
        queue_high_frac: queued rows over this fraction of
            ``max_queue_rows`` reads as overload even with a quiet burn
            rate — the shed-before-the-breach signal.
        queue_low_frac: a calm window needs the queue at/under this.
        up_consecutive / down_consecutive: control steps a signal must
            persist before acting (scale-down deliberately slower).
        cooldown_s: minimum seconds between actions in the same
            direction.
        quota_tighten_frac: under overload each tenant quota becomes
            ``ceil(base × frac)``; restored when calm.
        floor_slack_ms: the coalescing-window attribution margin.  A wide
            window puts a latency floor of ~``max_wait_ms`` under every
            request; a p99 within ``2·max_wait_ms + floor_slack_ms``
            (window + straggler + device/jitter envelope) is the
            controller's OWN window, not demand — it reads as calm (scale
            the window back down) and never as burn-overload (else a
            window at its bound and a tight target would read every
            second as overload and the controller could never retreat —
            the self-inflicted-burn deadlock the storm bench exposed).
        demand_release_frac: scale-down additionally requires the
            windowed request rate to have dropped to this fraction of
            the rate seen at the last overload — a wide window *serving
            a burst well* has a quiet burn rate, and without this guard
            the controller would un-provision mid-burst and oscillate.
            The tracked overload rate decays 10%/step once overload
            clears, so the guard releases within a few control steps of
            the burst actually ending (holding burst provisioning — and
            tightened admission quotas — against ordinary post-burst
            traffic would throttle the recovery it exists to protect).
    """

    def __init__(self, *, lanes_max: int = 4, lanes_min: Optional[int] = None,
                 max_wait_ms_max: float = 16.0,
                 max_wait_ms_min: Optional[float] = None,
                 p99_target_ms: float = 100.0,
                 burn_up: float = 1.0, burn_down: float = 0.25,
                 queue_high_frac: float = 0.25, queue_low_frac: float = 0.02,
                 up_consecutive: int = 1, down_consecutive: int = 4,
                 cooldown_s: float = 1.0, quota_tighten_frac: float = 0.5,
                 floor_slack_ms: float = 10.0,
                 demand_release_frac: float = 0.6):
        if lanes_max < 1:
            raise ValueError(f"lanes_max must be >= 1, got {lanes_max}")
        if lanes_min is not None and not 1 <= lanes_min <= lanes_max:
            raise ValueError(
                f"lanes_min {lanes_min} not in [1, {lanes_max}]")
        if max_wait_ms_max < 0:
            raise ValueError("max_wait_ms_max must be >= 0")
        if not 0.0 <= burn_down <= burn_up:
            raise ValueError(
                f"need 0 <= burn_down <= burn_up, got {burn_down}/{burn_up}")
        if up_consecutive < 1 or down_consecutive < 1:
            raise ValueError("consecutive thresholds must be >= 1")
        if not 0.0 < quota_tighten_frac <= 1.0:
            raise ValueError(
                f"quota_tighten_frac must be in (0, 1], got "
                f"{quota_tighten_frac}")
        self.lanes_max = int(lanes_max)
        self.lanes_min = None if lanes_min is None else int(lanes_min)
        self.max_wait_ms_max = float(max_wait_ms_max)
        self.max_wait_ms_min = (None if max_wait_ms_min is None
                                else float(max_wait_ms_min))
        self.p99_target_ms = float(p99_target_ms)
        self.burn_up = float(burn_up)
        self.burn_down = float(burn_down)
        self.queue_high_frac = float(queue_high_frac)
        self.queue_low_frac = float(queue_low_frac)
        self.up_consecutive = int(up_consecutive)
        self.down_consecutive = int(down_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.quota_tighten_frac = float(quota_tighten_frac)
        if floor_slack_ms < 0:
            raise ValueError(
                f"floor_slack_ms must be >= 0, got {floor_slack_ms}")
        self.floor_slack_ms = float(floor_slack_ms)
        if not 0.0 < demand_release_frac <= 1.0:
            raise ValueError(
                f"demand_release_frac must be in (0, 1], got "
                f"{demand_release_frac}")
        self.demand_release_frac = float(demand_release_frac)


class AutoscaleController:
    """One control loop over one batcher (and optionally its registry's
    tenant quotas).

    Args:
        batcher: the :class:`~dist_svgd_torch.serving.batcher.MicroBatcher`
            to actuate (``set_lanes`` / ``set_max_wait_ms`` seams).
        metrics: the ``MetricsRegistry`` the batcher writes into — the
            controller's signal source (default: the batcher's own).
        model_registry: optional :class:`~dist_svgd_torch.serving.registry.
            ModelRegistry` whose per-tenant quotas are tightened under
            overload and restored when calm (tenants without a quota are
            left alone — no quota means no admission contract to tighten).
        policy: :class:`AutoscalePolicy` bounds + hysteresis.
        clock: injectable monotonic time source (tests drive cooldowns
            deterministically).
    """

    def __init__(self, batcher, *, metrics=None, model_registry=None,
                 policy: Optional[AutoscalePolicy] = None,
                 clock=time.monotonic):
        self.batcher = batcher
        self.model_registry = model_registry
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.metrics = (metrics if metrics is not None
                        else getattr(batcher, "registry", None))
        if self.metrics is None:
            self.metrics = _metrics.default_registry()
        self._clock = clock
        # construction-time baseline: the scale-down floor unless the
        # policy pins explicit minimums
        self.baseline_lanes = int(batcher.lanes)
        self.baseline_max_wait_ms = float(batcher.max_wait_ms)
        self._lanes_min = (self.policy.lanes_min
                          if self.policy.lanes_min is not None
                          else min(self.baseline_lanes, self.policy.lanes_max))
        self._wait_min = (self.policy.max_wait_ms_min
                          if self.policy.max_wait_ms_min is not None
                          else min(self.baseline_max_wait_ms,
                                   self.policy.max_wait_ms_max))
        # the controller's OWN windows (never the /slo endpoint's engine —
        # two pollers on one stateful window would starve each other).
        # aggregate=True: in multi-tenant mode every serving series
        # carries a tenant= label and the unlabelled series never exists,
        # so a single-label-set window would read zero forever — the
        # aggregate mode sums across label sets (the empty set included,
        # so single-tenant batchers read identically)
        self._slo = default_serving_slos(
            self.metrics, p99_ms=self.policy.p99_target_ms,
            mirror_metrics=False, aggregate=True,
            clock=lambda: self._clock())
        self._lat_window = HistogramWindow(
            self.metrics, "svgd_serve_request_latency_seconds",
            aggregate=True)
        self._shed_window = CounterWindow(
            self.metrics, "svgd_serve_shed_total", aggregate=True)
        self._req_window = CounterWindow(
            self.metrics, "svgd_serve_requests_total", aggregate=True)
        self._m_actions = self.metrics.counter(
            "svgd_autoscale_actions_total",
            "autoscale actions by knob and direction")
        self._m_overload = self.metrics.gauge(
            "svgd_autoscale_overload",
            "1 while the controller reads the batcher as overloaded")
        self._m_quota_scale = self.metrics.gauge(
            "svgd_autoscale_quota_scale",
            "current tenant-quota scale (1.0 = base quotas)")
        self._m_quota_scale.set(1.0)
        # prime every window at construction: the first control step must
        # judge the delta since NOW — a controller attached to a
        # long-running registry would otherwise read the registry's whole
        # history as one giant "overload" window and act on stale load
        self._slo.evaluate()
        self._lat_window.poll()
        self._shed_window.poll()
        self._req_window.poll()

        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._last_up = -math.inf
        self._last_down = -math.inf
        self._steps = 0
        self._actions = 0
        # windowed request count seen at the most recent overload (decays
        # ~2%/step) — the demand-release guard's reference level
        self._overload_requests: Optional[float] = None
        self.quota_scale = 1.0
        self._base_quotas: Dict[str, int] = {}
        #: Bounded decision log (newest last) — the ``/autoscale`` body.
        self.log: deque = deque(maxlen=64)
        self._last_signals: Dict[str, Any] = {}

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # signals

    def _read_signals(self) -> Dict[str, Any]:
        doc = self._slo.evaluate()
        burns = self._slo.burn_rates()
        burn = burns.get("serve_p99", 0.0)
        if burn is None:  # unbounded ratio: worst case, never "fine"
            burn = math.inf
        shed = self._shed_window.poll()
        requests = self._req_window.poll()
        lat = self._lat_window.poll(self.policy.p99_target_ms / 1e3)
        depth = self.batcher.queued_rows()
        queue_frac = depth / max(self.batcher.max_queue_rows, 1)
        return {
            "burn": burn,
            "slo_status": doc["status"],
            "shed_delta": shed,
            "request_delta": requests,
            "window_count": lat["count"],
            "window_p99_ms": round(lat["p99_s"] * 1e3, 3),
            "queue_rows": depth,
            "queue_frac": round(queue_frac, 4),
            "lanes": self.batcher.lanes,
            "max_wait_ms": round(self.batcher.max_wait_ms, 3),
        }

    # ------------------------------------------------------------------ #
    # actuation

    def _scale_up(self, now: float, sig: Dict[str, Any]) -> List[str]:
        actions = []
        lanes = self.batcher.lanes
        if lanes < self.policy.lanes_max:
            self.batcher.set_lanes(lanes + 1)
            self._m_actions.inc(knob="lanes", direction="up")
            actions.append(f"lanes {lanes}->{lanes + 1}")
        wait = self.batcher.max_wait_ms
        if wait < self.policy.max_wait_ms_max:
            new = min(max(wait * 2.0, 0.5), self.policy.max_wait_ms_max)
            if new > wait:
                self.batcher.set_max_wait_ms(new)
                self._m_actions.inc(knob="max_wait_ms", direction="up")
                actions.append(f"max_wait_ms {wait:g}->{new:g}")
        if self.model_registry is not None and self.quota_scale > (
                self.policy.quota_tighten_frac):
            self._apply_quota_scale(self.policy.quota_tighten_frac)
            actions.append(f"quota_scale -> {self.quota_scale:g}")
        return actions

    def _scale_down(self, now: float, sig: Dict[str, Any]) -> List[str]:
        actions = []
        lanes = self.batcher.lanes
        if lanes > self._lanes_min:
            self.batcher.set_lanes(lanes - 1)
            self._m_actions.inc(knob="lanes", direction="down")
            actions.append(f"lanes {lanes}->{lanes - 1}")
        wait = self.batcher.max_wait_ms
        if wait > self._wait_min:
            new = max(wait / 2.0, self._wait_min)
            if new < wait:
                self.batcher.set_max_wait_ms(new)
                self._m_actions.inc(knob="max_wait_ms", direction="down")
                actions.append(f"max_wait_ms {wait:g}->{new:g}")
        if self.model_registry is not None and self.quota_scale < 1.0:
            self._apply_quota_scale(1.0)
            actions.append("quota_scale -> 1")
        return actions

    def _apply_quota_scale(self, scale: float) -> None:
        """Retune every quota'd tenant to ``ceil(base × scale)`` (base
        quotas are snapshotted the first time a tenant is tightened, and
        refreshed for tenants added since).  While tightened, the batcher
        runs **admission-enforced** quotas (``set_quota_mode``): a
        flooding tenant is refused before it occupies queue rows every
        other tenant would wait behind — the shed-*before*-the-breach
        mechanism; restoring the base quotas restores the inert-until-
        overflow default."""
        reg = self.model_registry
        for name, base in reg.quota_snapshot().items():
            if base is None:
                continue
            if name not in self._base_quotas:
                self._base_quotas[name] = base
        for name, base in list(self._base_quotas.items()):
            try:
                reg.set_quota(name, max(1, math.ceil(base * scale)))
            except KeyError:
                del self._base_quotas[name]  # tenant removed since
        if hasattr(self.batcher, "set_quota_mode"):
            self.batcher.set_quota_mode(
                "admission" if scale < 1.0 else "overflow")
        self.quota_scale = scale
        self._m_quota_scale.set(scale)
        self._m_actions.inc(knob="quota", direction=(
            "up" if scale >= 1.0 else "down"))

    # ------------------------------------------------------------------ #
    # the control iteration

    def step(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One control iteration: read the windows, update the hysteresis
        streaks, act when a streak crosses its threshold and the cooldown
        allows.  Returns the decision record (also appended to
        :attr:`log`)."""
        with self._lock:
            now = self._clock() if now is None else now
            sig = self._read_signals()
            p = self.policy
            # window-floor attribution: latency within the current
            # coalescing window (+ straggler + device/jitter slack) is the
            # controller's own doing, not demand — it must read as
            # "retreat", never as "overload" (AutoscalePolicy.floor_slack_ms)
            floor_ok = (sig["window_count"] == 0
                        or sig["window_p99_ms"]
                        <= 2.0 * self.batcher.max_wait_ms + p.floor_slack_ms)
            sig["window_floor_ok"] = floor_ok
            overload = ((sig["burn"] >= p.burn_up and not floor_ok)
                        or sig["shed_delta"] > 0
                        or sig["queue_frac"] >= p.queue_high_frac)
            if overload:
                self._overload_requests = max(
                    sig["request_delta"], self._overload_requests or 0.0)
            elif self._overload_requests is not None:
                # forget the burst's reference level within a few seconds
                # of overload ending: the guard exists to stop MID-burst
                # retreat, not to hold burst provisioning (and tightened
                # admission quotas) against post-burst traffic forever
                self._overload_requests *= 0.9
            # demand release: a wide window serving a burst WELL has a
            # quiet burn — only the offered rate falling reads as "the
            # burst is over" (AutoscalePolicy.demand_release_frac).  A
            # STRONG release (rate down to 70% of the release point)
            # reads as quiet on its own: with demand collapsed and the
            # queue empty, elevated window latency is self-inflicted
            # provisioning — retreat is safe, and a wrong retreat just
            # re-triggers scale-up one control step later.
            demand_ok = (self._overload_requests is None
                         or sig["request_delta"]
                         <= p.demand_release_frac * self._overload_requests)
            strong_release = (self._overload_requests is not None
                              and sig["request_delta"]
                              <= 0.7 * p.demand_release_frac
                              * self._overload_requests)
            sig["demand_released"] = demand_ok
            calm = (sig["shed_delta"] == 0
                    and sig["queue_frac"] <= p.queue_low_frac
                    and demand_ok
                    and (sig["burn"] <= p.burn_down or floor_ok
                         or strong_release))
            if overload:
                self._up_streak += 1
                self._down_streak = 0
            elif calm:
                self._down_streak += 1
                self._up_streak = 0
            else:
                # in-between: hold — neither streak advances (a noisy
                # boundary signal must not ratchet either direction)
                self._up_streak = 0
                self._down_streak = 0
            self._m_overload.set(1.0 if overload else 0.0)
            actions: List[str] = []
            if (overload and self._up_streak >= p.up_consecutive
                    and now - self._last_up >= p.cooldown_s):
                actions = self._scale_up(now, sig)
                if actions:
                    self._last_up = now
            elif (calm and self._down_streak >= p.down_consecutive
                    and now - self._last_down >= p.cooldown_s):
                actions = self._scale_down(now, sig)
                if actions:
                    self._last_down = now
            self._steps += 1
            self._actions += len(actions)
            record = {
                "ts": round(now, 3),
                "overload": overload,
                "calm": calm,
                "actions": actions,
                **sig,
            }
            self._last_signals = sig
            if actions or overload:
                self.log.append(record)
            return record

    # ------------------------------------------------------------------ #
    # lifecycle / introspection

    def start(self, interval_s: float = 0.25) -> "AutoscaleController":
        """Run :meth:`step` every ``interval_s`` on a daemon thread."""
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        if self._thread is None:
            self._stop.clear()
            self.interval_s = float(interval_s)

            def loop():
                while not self._stop.is_set():
                    try:
                        self.step()
                    except Exception:  # a control bug must not kill serving
                        pass
                    self._stop.wait(self.interval_s)

            self._thread = threading.Thread(
                target=loop, name="autoscale", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def status(self) -> Dict[str, Any]:
        """The ``/autoscale`` document: live knobs, bounds, streaks, and
        the recent decision log."""
        with self._lock:
            p = self.policy
            return {
                "lanes": self.batcher.lanes,
                "max_wait_ms": round(self.batcher.max_wait_ms, 3),
                "quota_scale": self.quota_scale,
                "baseline": {"lanes": self.baseline_lanes,
                             "max_wait_ms": self.baseline_max_wait_ms},
                "bounds": {"lanes": [self._lanes_min, p.lanes_max],
                           "max_wait_ms": [self._wait_min,
                                           p.max_wait_ms_max]},
                "p99_target_ms": p.p99_target_ms,
                "steps": self._steps,
                "actions": self._actions,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "last_signals": dict(self._last_signals),
                "recent": list(self.log)[-8:],
            }

    def __enter__(self) -> "AutoscaleController":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
