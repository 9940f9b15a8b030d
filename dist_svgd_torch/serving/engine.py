"""Predictive engine: per-model posterior-predictive programs over a
checkpointed ensemble, behind a shape-bucketed program cache.

Counterpart of ``dist_svgd_tpu/serving/engine.py`` (``bucket_for``,
``EnsembleRejected``, ``PredictiveEngine``, ``CheckpointHotReloader``):

- **Checkpoint cold start** (:meth:`PredictiveEngine.from_checkpoint`): a
  single ``save_state`` dir loads via ``load_state``; a ``CheckpointManager``
  root restores the newest *loadable* step (corrupt/partial newest dirs are
  skipped); a list of paths is one multi-process save, reassembled into the
  global ensemble via ``assemble_full_state``.
- **Shape-bucketed program cache**: a request batch of ``b`` rows pads up
  to the next power-of-two bucket (≥ ``min_bucket``) and runs the bucket's
  program (``parallel/plan.py``: one CUDA graph on the card, captured once;
  eager on the CPU), so at most ``log2(max_bucket/min_bucket)+1`` programs
  exist regardless of traffic mix.  Hits/misses are counted
  (:meth:`stats`) — steady-state traffic must be all hits.
- **Low precision**: an opt-in ``dtype=torch.bfloat16`` stores and
  computes the ensemble in bf16 while the request/response surfaces stay
  f32 (inputs cast inside the program, outputs upcast; means and variances
  accumulate in f32 as ``jnp.mean`` / ``jnp.var`` do).
- **Hot reload** with ``ReloadPolicy`` admission, an O(1) ``rollback`` to
  the resident previous generation, and a staged candidate generation
  (``stage_candidate`` / ``promote_candidate`` / ``drop_candidate``,
  ``predict(generation='candidate')``) that a rollout controller drives —
  the hot reloader offers newer steps to one with ``rollout=``.

Padding happens on the host and the padding is sliced off after the fetch:
the device only ever sees bucket shapes, so mixed request sizes never
capture a new graph.  Every per-row output depends only on that row, so
the served values equal a direct call on the same rows (bitwise on the
CPU; on the card the padded bucket's matmul may round a row differently
from the direct call's).

The engine runs on the card unless ``device='cpu'`` (or a CPU ``plan``) is
passed.  A ``mesh=``, or a plan over more than one device, raises
``NotImplementedError`` naming ROADMAP A10.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dist_svgd_torch.models import bnn as bnn_model
from dist_svgd_torch.models.logreg import posterior_predictive_prob
from dist_svgd_torch.parallel.plan import Plan
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.telemetry import usage as _usage

_LOG_2PI = math.log(2.0 * math.pi)

MODELS = ("logreg", "bnn", "gmm")

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class EnsembleRejected(RuntimeError):
    """A hot reload was refused: the candidate ensemble's diagnostics
    regressed past the engine's :class:`~dist_svgd_torch.telemetry.
    diagnostics.ReloadPolicy` thresholds.  ``reasons`` lists the failed
    checks; ``report`` carries the candidate's health statistics."""

    def __init__(self, reasons, report):
        super().__init__("ensemble rejected: " + "; ".join(reasons))
        self.reasons = list(reasons)
        self.report = report


def bucket_for(rows: int, min_bucket: int) -> int:
    """Smallest power-of-two ≥ ``rows``, clamped up to ``min_bucket``."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    return max(min_bucket, 1 << (rows - 1).bit_length())


def _looks_like_manager_root(path: str) -> bool:
    from dist_svgd_torch.utils.checkpoint import _STEP_DIR_RE

    return any(
        _STEP_DIR_RE.match(name) and os.path.isdir(os.path.join(path, name))
        for name in os.listdir(path)
    )


def _resolve_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype, or a name (``'bfloat16'``) or numpy dtype of one."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    resolved = getattr(torch, name, None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"dtype must be a float dtype, got {dtype!r}")
    return resolved


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class PredictiveEngine:
    """Low-latency posterior-predictive evaluation of one particle ensemble.

    Args:
        model: ``'logreg'`` (class-probability mean + variance over the
            ensemble — α decoded but unused, reference quirk), ``'bnn'``
            (regression mean + std on the original target scale,
            ``models/bnn.py:unpack`` layout), or ``'gmm'`` (ensemble KDE
            log-density: the mixture of ``N(θ_p, kde_bandwidth²·I)`` over
            particles).
        particles: ``(n, d)`` ensemble (numpy array or tensor).
        n_features / n_hidden: BNN layout (``n_features`` is required for
            ``'bnn'``; ``d`` must equal ``num_params``).
        y_mean / y_std: BNN target destandardisation.
        kde_bandwidth: GMM KDE kernel width.
        min_bucket / max_bucket: padding-bucket range, each rounded UP to a
            power of two (so ``warmup()`` covers every reachable bucket).
            Requests larger than the rounded ``max_bucket`` are rejected —
            the batcher splits oversize requests first.
        plan / mesh: the :class:`~dist_svgd_torch.parallel.plan.Plan` the
            bucket programs compile under (default: a single-device plan on
            ``device``).  ``mesh``, or a plan over more than one device,
            raises ``NotImplementedError`` (ROADMAP A10).
        dtype: opt-in low-precision serve path (``torch.bfloat16`` or
            ``'bfloat16'``): the ensemble is stored and the programs
            compute in this dtype; request/response surfaces stay f32.
            ``None`` keeps the checkpoint's dtype.
        donate: recorded on every program (``donate_argnums``); on the card
            the static graph input is reused whatever it says.
        registry: ``telemetry.MetricsRegistry`` for the program-cache
            counters (default: the process-wide registry).
        reload_policy: optional ``telemetry.diagnostics.ReloadPolicy``
            judging every :meth:`reload` candidate; a regressed one raises
            :class:`EnsembleRejected` instead of being swapped in.
        tenant: multi-tenant identity: every engine metric carries a
            ``tenant=`` label (``None`` keeps the unlabelled series).
        kernel_cache: optional shared
            :class:`~dist_svgd_torch.serving.registry.KernelBucketLRU`
            bounding compiled buckets across engines; an evicted bucket
            drops its program, and with it its CUDA graph and memory pool.
        device: the device of the default plan (``None`` is the card).
    """

    def __init__(
        self,
        model: str,
        particles,
        *,
        n_features: Optional[int] = None,
        n_hidden: int = 50,
        y_mean: float = 0.0,
        y_std: float = 1.0,
        kde_bandwidth: float = 1.0,
        min_bucket: int = 8,
        max_bucket: int = 4096,
        plan: Optional[Plan] = None,
        mesh=None,
        dtype=None,
        donate: bool = True,
        registry: Optional[_metrics.MetricsRegistry] = None,
        reload_policy=None,
        tenant: Optional[str] = None,
        kernel_cache=None,
        device=None,
    ):
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")
        if min_bucket < 1 or max_bucket < min_bucket:
            raise ValueError(
                f"need 1 <= min_bucket <= max_bucket, got {min_bucket}/{max_bucket}"
            )
        if plan is not None and mesh is not None:
            raise ValueError("pass plan= or mesh=, not both")
        if plan is not None and plan.num_shards > 1:
            raise NotImplementedError(
                "a plan over more than one device is not ported to PyTorch yet "
                "(ROADMAP A10)")
        if plan is not None and device is not None and torch.device(device) != plan.device:
            raise ValueError(f"device {device} differs from the plan's {plan.device}")
        self._plan = plan if plan is not None else Plan(mesh, device=device)
        self._donate = bool(donate)
        self._compute_dtype = _resolve_dtype(dtype)
        if (self._compute_dtype is not None
                and not self._compute_dtype.is_floating_point):
            raise ValueError(f"dtype must be a float dtype, got {self._compute_dtype}")
        # normalise both ends up to powers of two: a non-pow2 max_bucket
        # would otherwise admit requests whose bucket warmup() never built
        min_bucket = 1 << (min_bucket - 1).bit_length()
        max_bucket = 1 << (max_bucket - 1).bit_length()
        self._particles = self._place_ensemble(particles)
        self.model = model
        n, d = self._particles.shape
        if model == "logreg":
            if d < 2:
                raise ValueError("logreg particles need d >= 2 (log α, w)")
            self._feature_dim = d - 1
        elif model == "bnn":
            if n_features is None:
                raise ValueError("model='bnn' requires n_features")
            want = bnn_model.num_params(n_features, n_hidden)
            if d != want:
                raise ValueError(
                    f"bnn particles have d={d}, but num_params(n_features="
                    f"{n_features}, n_hidden={n_hidden}) = {want}"
                )
            self._feature_dim = n_features
        else:  # gmm: queries live in particle space
            self._feature_dim = d
        self._n_features = n_features
        self._n_hidden = n_hidden
        self._y_mean = float(y_mean)
        self._y_std = float(y_std)
        if kde_bandwidth <= 0:
            raise ValueError("kde_bandwidth must be positive")
        self._kde_bandwidth = float(kde_bandwidth)
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        # bucket -> program, guarded for concurrent predict() callers;
        # reload() swaps (_particles, _kernels) as a pair under the same
        # lock, so every predict sees one consistent generation
        self._kernels: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._reloads = 0
        self._evictions = 0
        # generation identity: the cold-start ensemble is generation 1;
        # each admitted reload / staged candidate mints the next id.  The
        # previous generation stays resident (particles + programs), so
        # rollback() is one lock-guarded pointer exchange
        self._generation_id = 1
        self._next_generation = 2
        self._prev_particles: Optional[torch.Tensor] = None
        self._prev_kernels: Optional[Dict[int, Any]] = None
        self._prev_tag: Optional[str] = None
        self._prev_generation: Optional[int] = None
        self._prev_health: Optional[Dict[str, Any]] = None
        self._rollbacks = 0
        # the candidate generation: staged by stage_candidate(), served only
        # via predict(generation='candidate')
        self._cand_particles: Optional[torch.Tensor] = None
        self._cand_kernels: Optional[Dict[int, Any]] = None
        self._cand_tag: Optional[str] = None
        self._cand_generation: Optional[int] = None
        #: Tenant identity on every metric series (empty dict = unlabelled).
        self.tenant = tenant
        self._tlabels = {} if tenant is None else {"tenant": str(tenant)}
        self._kernel_cache = kernel_cache
        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        self._m_hits = reg.counter(
            "svgd_engine_bucket_hits_total", "padding-bucket kernel-cache hits")
        self._m_misses = reg.counter(
            "svgd_engine_bucket_misses_total",
            "padding-bucket kernel-cache misses (one graph capture each on the card)")
        self._m_reloads = reg.counter(
            "svgd_engine_reloads_total", "hot ensemble swaps")
        self._m_reload_wall = reg.histogram(
            "svgd_engine_reload_wall_s",
            "wall per hot ensemble swap (policy judge + program rebuild + "
            "warm + pointer exchange) — the freshness budget's reload leg")
        self._m_reload_rejects = reg.counter(
            "svgd_engine_reload_rejected_total",
            "hot reloads refused by the ensemble-health policy")
        self._m_evictions = reg.counter(
            "svgd_registry_evictions_total",
            "compiled kernel buckets evicted by the shared LRU")
        self._m_rollbacks = reg.counter(
            "svgd_engine_rollbacks_total",
            "O(1) swaps back to the resident previous generation")
        self._reload_policy = reload_policy
        self._reload_rejects = 0
        # served ensemble's health baseline (computed lazily at the first
        # policied reload; refreshed on every admitted swap)
        self._health_report: Optional[Dict[str, Any]] = None
        self._ensemble_tag: Optional[str] = None
        #: Manager-root step this ensemble was cold-started from (set by
        #: :meth:`from_checkpoint`; ``None`` for direct construction).
        self.checkpoint_step: Optional[int] = None

    # ------------------------------------------------------------------ #
    # construction from checkpoints

    @classmethod
    def from_checkpoint(
        cls,
        source: Union[str, Sequence[str]],
        model: str,
        *,
        key: str = "particles",
        **kwargs,
    ) -> "PredictiveEngine":
        """Build an engine from any of the repo's checkpoint layouts.

        ``source`` may be: a single checkpoint dir (``save_state`` layout), a
        ``CheckpointManager`` root (``step_<t>/`` children — the newest
        *loadable* step is restored, skipping corrupt/partial ones), or a
        list/tuple of per-process paths from ONE multi-host save (reassembled
        with ``assemble_full_state``).  ``key`` selects the ensemble entry.
        """
        from dist_svgd_torch.utils.checkpoint import (
            CheckpointManager,
            assemble_full_state,
            load_state,
        )

        loaded_step = None
        if isinstance(source, (list, tuple)):
            state = assemble_full_state(list(source))
        else:
            path = os.fspath(source)
            if not os.path.isdir(path):
                raise FileNotFoundError(f"checkpoint path {path!r} is not a directory")
            if _looks_like_manager_root(path):
                loaded_step, state = CheckpointManager(path).restore_latest(
                    with_step=True
                )
                if state is None:
                    raise ValueError(
                        f"no restorable checkpoint under manager root {path!r}"
                    )
            else:
                state = load_state(path)
        if state.get(key) is None:
            raise KeyError(
                f"checkpoint has no {key!r} entry (keys: {sorted(state)})"
            )
        engine = cls(model, np.asarray(state[key]), **kwargs)
        # the step this ensemble came from (None for non-manager layouts):
        # CheckpointHotReloader's baseline
        engine.checkpoint_step = loaded_step
        return engine

    # ------------------------------------------------------------------ #
    # programs

    @property
    def particles(self) -> torch.Tensor:
        """The served ensemble (read-only by convention)."""
        return self._particles

    @property
    def n_particles(self) -> int:
        return int(self._particles.shape[0])

    @property
    def feature_dim(self) -> int:
        """Expected per-row input width for :meth:`predict`."""
        return self._feature_dim

    @property
    def plan(self) -> Plan:
        """The plan the bucket programs compile under."""
        return self._plan

    @property
    def device(self) -> torch.device:
        return self._plan.device

    def _place_ensemble(self, particles) -> torch.Tensor:
        """Validate, (optionally) cast to the compute dtype, and place on the
        plan's device — cold start, :meth:`reload` and candidates alike, so
        a hot swap can never de-cast the served ensemble."""
        arr = self._plan.shard_ensemble(
            np.asarray(particles) if not isinstance(particles, torch.Tensor) else particles)
        if arr.dim() != 2:
            raise ValueError(
                f"particles must be (n, d), got shape {tuple(arr.shape)}"
            )
        if self._compute_dtype is not None and arr.dtype != self._compute_dtype:
            arr = arr.to(self._compute_dtype)
        return arr

    @staticmethod
    def _input_dtype(particle_dtype: torch.dtype) -> torch.dtype:
        """Request-surface dtype: the ensemble's own, except sub-f32 compute
        dtypes keep an f32 wire format (the program casts inside)."""
        return torch.float32 if particle_dtype.itemsize < 4 else particle_dtype

    def _build_kernel(self, particles: torch.Tensor):
        """The padded-batch predictive program over ``particles`` (one
        program per bucket; the ensemble is closed over, so a hot reload
        builds a fresh set instead of mutating served ones)."""
        low_precision = particles.dtype.itemsize < 4
        dt = particles.dtype

        # jnp.mean / jnp.var over the particle axis: a bf16 input
        # accumulates in f32 and the result is cast back; var is biased
        def mean(v):
            return v.float().mean(0).to(dt) if low_precision else v.mean(0)

        def var(v):
            return (v.float().var(0, correction=0).to(dt) if low_precision
                    else v.var(0, correction=0))

        if self.model == "logreg":

            def kernel(x):
                probs = posterior_predictive_prob(particles, x)  # (n, b)
                return {"mean": mean(probs), "var": var(probs)}

        elif self.model == "bnn":
            nf, nh = self._n_features, self._n_hidden
            y_mean, y_std = self._y_mean, self._y_std

            def kernel(x):
                preds = bnn_model._predictions(particles, x, nf, nh)  # (n, b)
                ens_var = var(preds) * y_std**2
                # predictive std folds in the mean observation-noise
                # variance E[1/γ] over the ensemble (original scale), in
                # the ensemble's dtype
                noise = mean(torch.exp(-particles[:, -2])) * y_std**2
                return {"mean": mean(preds) * y_std + y_mean,
                        "std": torch.sqrt(ens_var + noise)}

        else:  # gmm — ensemble KDE density
            h = self._kde_bandwidth
            d = self._feature_dim
            log_n = math.log(particles.shape[0])

            def kernel(x):
                sq = torch.sum((x[:, None, :] - particles[None, :, :]) ** 2, dim=-1)  # (b, n)
                logk = -0.5 * sq / (h * h) - d * math.log(h) - 0.5 * d * _LOG_2PI
                return {"log_density": torch.logsumexp(logk, dim=1) - log_n}

        def dispatch(x):
            # the wire stays f32 around a low-precision compute dtype: cast
            # in, compute in the ensemble's dtype, upcast out
            if low_precision:
                x = x.to(dt)
            out = kernel(x)
            if low_precision:
                out = {k: v.float() for k, v in out.items()}
            return out

        return self._plan.compile(
            dispatch, donate_argnums=(0,) if self._donate else (),
            label=f"serve.{self.model}", audit=dict(pinned_f32=not low_precision))

    def _record_compile(self, generation: str) -> None:
        """Feed one program-cache miss to the process usage meter (a no-op
        unless metering is enabled)."""
        meter = _usage.get_meter()
        if meter is not None:
            meter.record_compile(
                tenant=self.tenant,
                generation=None if generation == "serving" else generation)

    def _kernel_for(self, bucket: int, generation: str = "serving"):
        """Returns ``(program, dtype)`` snapshotted under one lock
        acquisition: a concurrent :meth:`reload` can never hand a caller the
        new ensemble's dtype with the old ensemble's program.

        ``generation='candidate'`` resolves against the staged candidate.
        Candidate buckets are never reported to the shared
        :class:`KernelBucketLRU`: a transient candidate's churn must not
        evict the incumbent's steady-state buckets."""
        if generation == "candidate":
            with self._lock:
                if self._cand_particles is None:
                    raise RuntimeError(
                        "no candidate generation staged; stage_candidate() "
                        "first (or the rollout already resolved)"
                    )
                fn = self._cand_kernels.get(bucket)
                if fn is None:
                    self._misses += 1
                    miss = True
                    fn = self._cand_kernels[bucket] = self._build_kernel(
                        self._cand_particles)
                else:
                    self._hits += 1
                    miss = False
                dtype = self._input_dtype(self._cand_particles.dtype)
            (self._m_misses if miss else self._m_hits).inc(**self._tlabels)
            if miss:
                self._record_compile(generation)
            return fn, dtype
        with self._lock:
            fn = self._kernels.get(bucket)
            if fn is None:
                self._misses += 1
                miss = True
                fn = self._kernels[bucket] = self._build_kernel(self._particles)
            else:
                self._hits += 1
                miss = False
            dtype = self._input_dtype(self._particles.dtype)
        # registry write outside the engine lock (its own lock suffices)
        (self._m_misses if miss else self._m_hits).inc(**self._tlabels)
        if miss:
            self._record_compile(generation)
        if self._kernel_cache is not None:
            # outside the engine lock: the shared LRU may evict another
            # engine's bucket (taking THAT engine's lock) — lock order is
            # always cache -> engine, so tenants cannot deadlock each other
            self._kernel_cache.touch(self, bucket)
        return fn, dtype

    def _evict_bucket(self, bucket: int) -> bool:
        """Shared-LRU eviction callback: drop one bucket's program (its CUDA
        graph and memory pool go when the last in-flight call lets go).  The
        next request on that bucket builds it again (a counted miss)."""
        with self._lock:
            existed = self._kernels.pop(bucket, None) is not None
            if existed:
                self._evictions += 1
        if existed:
            self._m_evictions.inc(**self._tlabels)
        return existed

    # ------------------------------------------------------------------ #
    # serving

    def predict(self, x, generation: str = "serving") -> Dict[str, np.ndarray]:
        """Evaluate one request batch ``x`` of shape ``(b, feature_dim)``.

        Pads to the power-of-two bucket on the host, runs the bucket's
        program, fetches, and slices the padding back off.  Returns numpy
        arrays of leading dimension ``b`` (the fetch is the fence the
        batcher's device-time split relies on).

        ``generation='candidate'`` dispatches against the staged candidate
        generation instead of the serving incumbent; ``RuntimeError`` when
        no candidate is staged.
        """
        if generation not in ("serving", "candidate"):
            raise ValueError(
                f"generation must be 'serving' or 'candidate', "
                f"got {generation!r}"
            )
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self._feature_dim:
            raise ValueError(
                f"expected (b, {self._feature_dim}) inputs, got shape {x.shape}"
            )
        b = x.shape[0]
        if b > self.max_bucket:
            raise ValueError(
                f"request of {b} rows exceeds max_bucket={self.max_bucket}; "
                "split it upstream (MicroBatcher max_batch does this)"
            )
        bucket = bucket_for(b, self.min_bucket)
        traced = _trace.enabled()
        tags = None
        if traced:
            tags = {"rows": b, "bucket": bucket, "model": self.model}
            ctx = _trace.get_trace_context()
            if ctx is not None:
                tags["trace"] = ctx
        with _trace.span("engine.predict", tags):
            fn, dtype = self._kernel_for(bucket, generation)
            wire = _NUMPY_DTYPES[dtype]
            if bucket != b:
                # pad on the HOST: a device-side pad would be a new program
                # shape per (b, bucket) pair — a graph capture per request
                # size while the bucket cache reports all hits
                with _trace.span("engine.pad"):
                    xp = np.zeros((bucket, x.shape[1]), dtype=wire)
                    xp[:b] = x
                    x = xp
            with _trace.span("engine.dispatch", {"bucket": bucket} if traced else None):
                out = fn(torch.from_numpy(np.ascontiguousarray(x, dtype=wire)))
                # slice AFTER the host fetch (same reason as the pad)
                return {k: v.numpy()[:b] for k, v in out.items()}

    def warmup(self, batch_sizes: Optional[List[int]] = None) -> List[int]:
        """Build every bucket's program (a graph capture each on the card)
        so first requests don't pay for it.  Defaults to every bucket from
        ``min_bucket`` up to ``max_bucket``; returns the buckets built."""
        if batch_sizes is None:
            buckets = []
            bkt = self.min_bucket
            while bkt <= self.max_bucket:
                buckets.append(bkt)
                bkt *= 2
        else:
            buckets = sorted({bucket_for(b, self.min_bucket) for b in batch_sizes})
        for bkt in buckets:
            self.predict(np.zeros((bkt, self._feature_dim), np.float32))
        return buckets

    # ------------------------------------------------------------------ #
    # hot reload (train-while-serving)

    def reload(self, particles, *, warm: bool = True,
               tag: Optional[str] = None) -> Dict[str, Any]:
        """Atomically swap the served ensemble.

        A fresh program is built per currently-built bucket over the NEW
        ensemble and (``warm=True``) run once — captured on the card —
        **before** the swap, off the request path.  The swap itself is one
        lock-guarded pointer exchange of the ``(_particles, _kernels)``
        pair, so every micro-batch is served entirely by one generation.

        The particle count may change; the particle width may not.
        Returns a summary dict; ``tag`` labels the generation in
        :meth:`stats`.  Runs inside a ``reload`` span, and an admitted
        swap's wall lands in ``svgd_engine_reload_wall_s``.
        """
        t0 = time.perf_counter()
        with _trace.span("reload", {"tag": tag}):
            info = self._reload_inner(particles, warm=warm, tag=tag)
        self._m_reload_wall.observe(time.perf_counter() - t0)
        return info

    def _check_layout(self, particles, what: str) -> torch.Tensor:
        cand = self._plan.shard_ensemble(
            np.asarray(particles) if not isinstance(particles, torch.Tensor) else particles)
        if cand.dim() != 2 or cand.shape[1] != self._particles.shape[1]:
            raise ValueError(
                f"{what} particles {tuple(cand.shape)} incompatible with the "
                f"served layout (n, {self._particles.shape[1]})"
            )
        return cand

    def _stage(self, particles: torch.Tensor, warm: bool, then) -> Dict[int, Any]:
        """Build (and warm) a program per live bucket over ``particles``
        outside the lock, then call ``then(new_kernels)`` under it once the
        staged set covers the live set (a predict may build a NEW bucket
        while we warm — swapping without it would drop it)."""
        warm_dtype = self._input_dtype(particles.dtype)
        new_kernels: Dict[int, Any] = {}
        with self._lock:
            buckets = sorted(self._kernels)
        while True:
            for b in buckets:
                if b not in new_kernels:
                    fn = self._build_kernel(particles)
                    if warm:
                        fn(torch.zeros((b, self._feature_dim), dtype=warm_dtype))
                    new_kernels[b] = fn
            with self._lock:
                missing = [b for b in self._kernels if b not in new_kernels]
                if not missing:
                    return then(new_kernels)
            buckets = missing

    def _reload_inner(self, particles, *, warm: bool,
                      tag: Optional[str]) -> Dict[str, Any]:
        cand = self._check_layout(particles, "reload")
        new_report = None
        if self._reload_policy is not None:
            new_report = self._reload_policy.evaluate(cand)
            if self._health_report is None:
                # first policied reload: baseline the ensemble now serving
                baseline = self._reload_policy.evaluate(self._particles)
                with self._lock:
                    if self._health_report is None:
                        self._health_report = baseline
            reasons = self._reload_policy.judge(new_report, self._health_report)
            if reasons:
                with self._lock:
                    self._reload_rejects += 1
                    serving_gen = self._generation_id
                # generation = the incumbent that KEPT serving
                self._m_reload_rejects.inc(generation=str(serving_gen), **self._tlabels)
                _trace.instant("engine.reload_rejected", {"tag": tag})
                rec = _trace.flight_recorder()
                if rec is not None:
                    try:
                        rec.record("reload_rejected", tag=tag, reasons=reasons, **new_report)
                        rec.dump("reload_rejected",
                                 {"tag": tag, "reasons": reasons, "candidate": new_report,
                                  "baseline": self._health_report})
                    except Exception:
                        # a failing dump must not replace EnsembleRejected —
                        # the hot reloader only handles that one
                        pass
                raise EnsembleRejected(reasons, new_report)
        particles = self._place_ensemble(cand)

        def swap(new_kernels):
            # keep the outgoing generation RESIDENT: rollback() is then one
            # pointer exchange, never a checkpoint re-load
            self._prev_particles = self._particles
            self._prev_kernels = self._kernels
            self._prev_tag = self._ensemble_tag
            self._prev_generation = self._generation_id
            self._prev_health = self._health_report
            self._particles = particles
            self._kernels = new_kernels
            self._reloads += 1
            self._ensemble_tag = tag
            self._generation_id = self._next_generation
            self._next_generation += 1
            if new_report is not None:
                self._health_report = new_report
            return self._generation_id, sorted(new_kernels)

        gen, warmed = self._stage(particles, warm, swap)
        self._m_reloads.inc(generation=str(gen), **self._tlabels)
        _trace.instant("engine.reload", {"tag": tag})
        return {"n_particles": int(particles.shape[0]), "warmed_buckets": warmed,
                "tag": tag, "generation_id": gen}

    # ------------------------------------------------------------------ #
    # generations

    def rollback(self) -> Dict[str, Any]:
        """Swap back to the still-resident previous generation — O(1), no
        checkpoint I/O.  The pairs exchange rather than pop, so a mistaken
        rollback is itself recoverable by a second call.  Raises
        ``RuntimeError`` when no previous generation is resident."""
        with self._lock:
            if self._prev_particles is None:
                raise RuntimeError(
                    "no previous generation resident; nothing to roll back to"
                )
            self._particles, self._prev_particles = (
                self._prev_particles, self._particles)
            self._kernels, self._prev_kernels = (
                self._prev_kernels, self._kernels)
            self._ensemble_tag, self._prev_tag = (
                self._prev_tag, self._ensemble_tag)
            self._generation_id, self._prev_generation = (
                self._prev_generation, self._generation_id)
            self._health_report, self._prev_health = (
                self._prev_health, self._health_report)
            self._rollbacks += 1
            gen = self._generation_id
            tag = self._ensemble_tag
            n = int(self._particles.shape[0])
        self._m_rollbacks.inc(generation=str(gen), **self._tlabels)
        _trace.instant("engine.rollback", {"tag": tag, "generation": gen})
        return {"generation_id": gen, "tag": tag, "n_particles": n}

    def stage_candidate(self, particles, *, warm: bool = True,
                        tag: Optional[str] = None) -> Dict[str, Any]:
        """Stage a candidate generation WITHOUT swapping it into serving:
        its own programs, built and warmed over every live bucket (the
        reload's staging, without the pointer exchange and without the
        reload policy).  Dispatch against it with ``predict(x,
        generation='candidate')``; install it with
        :meth:`promote_candidate`; discard it with :meth:`drop_candidate`.
        Returns ``{generation_id, warmed_buckets, tag}``."""
        particles = self._place_ensemble(self._check_layout(particles, "candidate"))

        def install(new_kernels):
            self._cand_particles = particles
            self._cand_kernels = new_kernels
            self._cand_tag = tag
            self._cand_generation = self._next_generation
            self._next_generation += 1
            return self._cand_generation, sorted(new_kernels)

        gen, warmed = self._stage(particles, warm, install)
        _trace.instant("engine.stage_candidate", {"tag": tag, "generation": gen})
        return {"generation_id": gen, "warmed_buckets": warmed, "tag": tag}

    def promote_candidate(self) -> Dict[str, Any]:
        """Install the staged candidate as the serving generation — O(1),
        counted as a reload; the outgoing incumbent stays resident for
        :meth:`rollback`, and the health baseline resets."""
        with self._lock:
            if self._cand_particles is None:
                raise RuntimeError("no candidate generation staged")
            self._prev_particles = self._particles
            self._prev_kernels = self._kernels
            self._prev_tag = self._ensemble_tag
            self._prev_generation = self._generation_id
            self._prev_health = self._health_report
            self._particles = self._cand_particles
            self._kernels = self._cand_kernels
            self._ensemble_tag = self._cand_tag
            self._generation_id = self._cand_generation
            self._health_report = None
            self._cand_particles = None
            self._cand_kernels = None
            self._cand_tag = None
            self._cand_generation = None
            self._reloads += 1
            gen = self._generation_id
            tag = self._ensemble_tag
            n = int(self._particles.shape[0])
        self._m_reloads.inc(generation=str(gen), **self._tlabels)
        _trace.instant("engine.promote", {"tag": tag, "generation": gen})
        return {"generation_id": gen, "tag": tag, "n_particles": n}

    def drop_candidate(self) -> bool:
        """Discard the staged candidate; returns whether one was staged."""
        with self._lock:
            existed = self._cand_particles is not None
            gen = self._cand_generation
            self._cand_particles = None
            self._cand_kernels = None
            self._cand_tag = None
            self._cand_generation = None
        if existed:
            _trace.instant("engine.drop_candidate", {"generation": gen})
        return existed

    def stats(self) -> Dict[str, Any]:
        """Program-cache and ensemble identity counters (JAX's keys)."""
        with self._lock:
            return {
                "model": self.model,
                "tenant": self.tenant,
                "n_particles": self.n_particles,
                "feature_dim": self._feature_dim,
                "dtype": _dtype_name(self._particles.dtype),
                "donate_inputs": self._donate,
                "plan": self._plan.describe(),
                "bucket_hits": self._hits,
                "bucket_misses": self._misses,
                "bucket_cache_size": len(self._kernels),
                "bucket_evictions": self._evictions,
                "compiled_buckets": sorted(self._kernels),
                "reloads": self._reloads,
                "reload_rejects": self._reload_rejects,
                "ensemble_tag": self._ensemble_tag,
                "ensemble_health": self._health_report,
                "generation_id": self._generation_id,
                "previous_generation_id": self._prev_generation,
                "candidate_generation_id": self._cand_generation,
                "candidate_tag": self._cand_tag,
                "rollbacks": self._rollbacks,
            }


class CheckpointHotReloader:
    """Watch a ``CheckpointManager`` root; hot-swap the engine's ensemble
    when training writes a newer step.

    Composes a supervised trainer (``resilience.RunSupervisor`` writing
    periodic checkpoints) with a live server into train-while-serving: the
    server cold-starts from the newest step, the reloader polls the root,
    and each newer restorable step is loaded off the request path and
    swapped in between micro-batches (:meth:`PredictiveEngine.reload`).
    A corrupt/partial newest step dir is simply skipped by the restore
    fallback — the server keeps serving the previous generation.

    Drive it explicitly with :meth:`poll_once` (tests, single-threaded
    drivers) or as a background thread via :meth:`start`/``with`` (the
    poll interval waits on an event, so :meth:`stop` returns promptly).

    Args:
        engine: the live :class:`PredictiveEngine`.
        root: the manager root being written by the trainer.
        key: ensemble entry in the checkpoint state dict.
        interval_s: background-thread poll cadence.
        baseline_step: the step already being served — newer steps trigger
            a swap.  Default ``'auto'`` uses the step the engine actually
            cold-started from (``engine.checkpoint_step``, recorded by
            ``from_checkpoint`` on a manager root — a save racing the cold
            start, or a corrupt newest dir the restore fell back past, is
            then correctly treated as *not yet served*); falls back to the
            root's current latest when the engine wasn't built from a
            manager root.  Pass ``None`` to force the first poll to load
            whatever is restorable, or an explicit step number.
        rollout: optional progressive-delivery controller
            (:class:`~dist_svgd_torch.rollout.RolloutController`, duck-typed
            on ``offer``).  When set, a newer step is **offered as a
            candidate** instead of swapped directly — the rollout drives
            it through shadow/canary stages and promotes or rolls back on
            live SLO windows; the serving watermark is stamped at
            *promotion*, not at offer.
        logger: optional ``JsonlLogger`` — one record per swap.
    """

    def __init__(self, engine: PredictiveEngine, root: str, *,
                 key: str = "particles", interval_s: float = 5.0,
                 baseline_step="auto", rollout=None, logger=None):
        from dist_svgd_torch.utils.checkpoint import CheckpointManager

        self.engine = engine
        self._mgr = CheckpointManager(os.fspath(root))
        self._key = key
        self._interval_s = float(interval_s)
        self.rollout = rollout
        self._logger = logger
        if baseline_step == "auto":
            baseline_step = getattr(engine, "checkpoint_step", None)
            if baseline_step is None:
                baseline_step = self._mgr.latest_step()
        self.loaded_step: Optional[int] = baseline_step
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[int]:
        """Check the root once; swap if a newer restorable step exists.
        Returns the newly served step, or ``None`` when nothing changed."""
        latest = self._mgr.latest_step()
        if latest is None or (self.loaded_step is not None
                              and latest <= self.loaded_step):
            return None
        step, state = self._mgr.restore_latest(with_step=True)
        if step is None or (self.loaded_step is not None
                            and step <= self.loaded_step):
            # every newer dir was corrupt/partial: keep serving the
            # current generation and try again next poll
            return None
        arr = state.get(self._key)
        if arr is None:
            raise KeyError(
                f"checkpoint step_{step} has no {self._key!r} entry "
                f"(keys: {sorted(state)})"
            )
        wm = state.get("stream_watermark")
        if self.rollout is not None:
            # progressive delivery: the new generation enters a staged
            # rollout instead of an atomic cutover.  The step is marked
            # seen either way — a superseded/deferred candidate is a
            # rollout decision, not a reason to re-offer the same step
            # forever.  The serving watermark is stamped by the rollout at
            # PROMOTION (candidate traffic is not "served" freshness-wise)
            offered = self.rollout.offer(
                np.asarray(arr), tag=f"step_{step}",
                watermark=(float(np.asarray(wm)) if wm is not None else None))
            self.loaded_step = step
            if self._logger is not None:
                self._logger.log(event="rollout_offer", step=step,
                                 accepted=bool(offered))
            return step if offered else None
        try:
            info = self.engine.reload(np.asarray(arr), tag=f"step_{step}")
        except EnsembleRejected as e:
            # the engine's health policy refused this generation: keep
            # serving the current one, but mark the step seen so the
            # poller doesn't re-evaluate the same bad checkpoint forever
            # (a later, healthier step will be picked up normally)
            self.loaded_step = step
            if self._logger is not None:
                self._logger.log(event="hot_reload_rejected", step=step,
                                 reasons=e.reasons)
            return None
        self.loaded_step = step
        if wm is not None:
            # streaming checkpoints stamp their data watermark: once this
            # generation serves, predictions reflect events up to `wm` —
            # the serving half of the freshness SLO's gauge pair.  Stamped
            # twice: the tenant-keyed series the FreshnessObjective reads
            # (exact label match), plus a generation-labelled series so a
            # mid-rollout fleet shows WHICH generation's data is serving
            gauge = self.engine.registry.gauge(
                "svgd_serving_watermark",
                "event-time data watermark of the served ensemble",
            )
            gauge.set(float(np.asarray(wm)), **self.engine._tlabels)
            gauge.set(float(np.asarray(wm)),
                      generation=str(info["generation_id"]),
                      **self.engine._tlabels)
        if self._logger is not None:
            self._logger.log(event="hot_reload", step=step, **info)
        return step

    def start(self) -> "CheckpointHotReloader":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ckpt-hot-reload", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # keep watching: one bad poll must not
                # kill the reloader thread (the server stays on the old
                # generation either way)
                try:
                    if self._logger is not None:
                        self._logger.log(event="hot_reload_error",
                                         error=f"{type(e).__name__}: {e}")
                except Exception:  # a closed/broken logger must not kill
                    pass           # the watcher either
            self._stop.wait(self._interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # a poll hung (e.g. a slow restore over a network fs): keep
                # the reference so start() can't spawn a duplicate poller
                # and a later stop() can retry the join
                try:
                    if self._logger is not None:
                        self._logger.log(
                            event="hot_reload_stop_timeout",
                            detail="poller still joining; reference kept",
                        )
                except Exception:
                    pass
                return
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
