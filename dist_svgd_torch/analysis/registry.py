"""Program registry: every tracked program of a run, observable after the
fact.

Counterpart of ``dist_svgd_tpu/analysis/registry.py``.  The auditor
(``analysis/audit.py``, ``tools/program_audit.py``) needs the *set* of
programs a run built and the shapes and dtypes each was first called with.
Two kinds of program register here:

- the :class:`~dist_svgd_torch.parallel.plan.Program` of ``Plan.compile``
  (the serving programs: a CUDA graph per input shape on the card), through
  :meth:`ProgramRegistry.register`;
- a plain eager callable — a sampler's step, the body of JAX's scanned
  program, called once a step — through :meth:`ProgramRegistry.track`,
  which returns the wrapper the caller hands out in its place.  The wrapper
  snapshots the first call's signature, counts calls and routes them
  through the dispatch profiler when one is enabled; in the steady state
  that is one flag check, a counter and one module-global read a call.

The first call's **signature** (``ProgramEntry.avals``) holds, per
positional argument:

- a tensor as ``(shape, dtype)`` (the form ``telemetry/profile.py`` sizes
  rows and bytes from);
- a Python ``int`` / ``float`` / ``bool`` as ``("scalar", value)``: a
  dynamic scalar input, typed on the card as JAX's call sites cast it —
  ``i32[]``, the dtype of the program's first floating tensor argument,
  ``i1[]`` (:func:`scalar_dtype`);
- a tuple, list or dict of tensors as ``("tree", <the same container of
  (shape, dtype)>)``;
- a static argument (``static_argnums``), ``None`` or any other value as
  ``("static", value)``.

A step takes its minibatch stream's root as the plain seed (an ``int``)
where JAX's program takes a threefry key; ``key_argnums`` names those
arguments, and the card spells each as JAX's key, ``ui32[2]``
(:data:`KEY_AVAL`) — the call itself is never reshaped for the audit.

The registry keeps no tensor alive: an entry holds a **weakref** to its
program (a dead entry is skipped by :meth:`ProgramRegistry.entries` and
pruned at the next registration), records shapes, dtypes and devices only,
and is bounded (FIFO eviction past ``capacity``).  :meth:`ProgramEntry.
call_args` rebuilds a call from the signature — floating tensors drawn from
a fixed seed, integer and boolean tensors zeros, scalars and statics as
recorded — so an audit never runs on, or advances, a sampler's own state.

Tests and the audit tool that want a private view swap the process default
with :func:`use_registry`; every registration asks :func:`default_registry`
at that moment, never a cached one.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# the dispatch profiler's switchboard (telemetry.profile never imports
# analysis, so this edge is acyclic)
from dist_svgd_torch.telemetry import profile as _profile

__all__ = ["ProgramEntry", "ProgramRegistry", "default_registry", "scalar_dtype",
           "use_registry"]

#: Seed of the floating tensors :meth:`ProgramEntry.call_args` draws.
CALL_ARGS_SEED = 0

#: How a card spells a ``key_argnums`` seed: JAX's threefry key.
KEY_AVAL = ((2,), torch.uint32)


def _as_tuple(v: Union[int, Sequence[int], Tuple, None]) -> Tuple[int, ...]:
    if v is None:
        return ()
    if isinstance(v, int):
        return (v,)
    return tuple(v)


def _tensor_aval(a) -> Tuple[tuple, torch.dtype]:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return (tuple(a.shape), a.dtype)


def _is_tensor(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray))


def _tree_avals(value):
    if _is_tensor(value):
        return _tensor_aval(value)
    if isinstance(value, dict):
        return {k: _tree_avals(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_tree_avals(v) for v in value)
    raise TypeError(f"a tree argument holds tensors only, got {type(value).__name__}")


def _aval_of(value, static: bool):
    if static or value is None:
        return ("static", value)
    if _is_tensor(value):
        return _tensor_aval(value)
    if isinstance(value, (bool, int, float, np.integer, np.floating)):
        return ("scalar", value)
    if isinstance(value, (tuple, list, dict)):
        try:
            return ("tree", _tree_avals(value))
        except TypeError:
            return ("static", value)
    return ("static", value)


def _device_of(value) -> Optional[torch.device]:
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, np.ndarray):
        return torch.device("cpu")
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        for v in value:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


def signature_of(args, static_argnums: Tuple[int, ...] = ()) -> tuple:
    """The signature record of one call's positional ``args`` (module
    docstring)."""
    return tuple(_aval_of(a, i in static_argnums) for i, a in enumerate(args))


def iter_tensor_avals(avals) -> List[Tuple[tuple, torch.dtype]]:
    """Every tensor leaf ``(shape, dtype)`` of a signature, in order."""
    out: List[Tuple[tuple, torch.dtype]] = []

    def walk(rec):
        if isinstance(rec, dict):
            for v in rec.values():
                walk(v)
        elif (isinstance(rec, (tuple, list)) and len(rec) == 2
              and isinstance(rec[1], torch.dtype)):
            out.append((tuple(rec[0]), rec[1]))
        elif isinstance(rec, (tuple, list)):
            for v in rec:
                walk(v)

    for rec in avals:
        if rec[0] == "tree":
            walk(rec[1])
        elif isinstance(rec[1], torch.dtype):
            out.append((tuple(rec[0]), rec[1]))
    return out


def scalar_dtype(value, avals) -> torch.dtype:
    """The dtype a Python scalar argument takes on a program's card: JAX's
    call sites cast a step counter to ``int32`` and every float (step size,
    bandwidth, W2 weight) to the particles' dtype — here the program's first
    floating tensor argument (the default dtype where it has none)."""
    if isinstance(value, (bool, np.bool_)):
        return torch.bool
    if isinstance(value, (int, np.integer)):
        return torch.int32
    for _, dtype in iter_tensor_avals(avals):
        if dtype.is_floating_point:
            return dtype
    return torch.get_default_dtype()


class ProgramEntry:
    """One tracked program: identity, declarations, counters and the first
    call's signature (``None`` until called).

    ``meta`` carries the call site's audit declarations (JAX's ``audit=``
    keys): ``gram_free`` (the program claims no n×n Gram in device memory —
    arms XP001), ``pinned_f32`` (arms XP005), ``expect_donation`` (XP003's
    stripped-donation check), ``particles_arg`` (the positional argument
    holding the ``(n, d)`` ensemble; default 0, ``None`` for none) and
    ``allow_f64`` (disarms XP004).  ``key_argnums`` are the seed arguments
    the card spells as JAX's key (module docstring).  ``shapes`` lists every distinct
    signature a :class:`~dist_svgd_torch.parallel.plan.Program` has seen
    (one CUDA graph each on the card); ``prof_cache`` is the dispatch
    profiler's per-entry cache."""

    __slots__ = ("seq", "label", "kind", "num_shards", "donate_argnums", "static_argnums",
                 "key_argnums", "meta", "_ref", "avals", "devices", "calls", "shapes",
                 "prof_cache", "__weakref__")

    def __init__(self, seq: int, label: str, kind: str, num_shards: int,
                 donate_argnums: Tuple[int, ...], meta: Optional[dict], ref,
                 static_argnums: Tuple[int, ...] = (), key_argnums: Tuple[int, ...] = ()):
        self.seq = seq
        self.label = label
        self.kind = kind
        self.num_shards = num_shards
        self.donate_argnums = donate_argnums
        self.static_argnums = static_argnums
        self.key_argnums = key_argnums
        self.meta = meta
        self._ref = ref
        self.avals: Optional[tuple] = None
        self.devices: Optional[tuple] = None
        self.calls = 0
        self.shapes: List[tuple] = []
        self.prof_cache = None

    @property
    def alive(self) -> bool:
        return self._ref() is not None

    @property
    def captured(self) -> bool:
        return self.avals is not None

    def program(self):
        """The program object (``None`` once it died)."""
        return self._ref()

    def capture(self, args) -> None:
        """Record ``args`` as the first call's signature."""
        self.devices = tuple(_device_of(a) for a in args)
        self.avals = signature_of(args, self.static_argnums)

    def call_args(self, device=None) -> tuple:
        """A call rebuilt from the first call's signature: floating tensors
        drawn from :data:`CALL_ARGS_SEED` (standard normal), integer and
        boolean tensors zeros, each on its recorded device (or ``device``),
        Python scalars and static arguments as recorded."""
        if self.avals is None:
            raise ValueError(f"program {self.label!r} was never called")
        gen = torch.Generator(device="cpu").manual_seed(CALL_ARGS_SEED)

        def build(aval, dev):
            shape, dtype = aval
            if dtype.is_floating_point:
                t = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
            else:
                t = torch.zeros(shape, dtype=dtype)
            return t.to(dev) if dev is not None else t

        def tree(rec, dev):
            if isinstance(rec, dict):
                return {k: tree(v, dev) for k, v in rec.items()}
            if isinstance(rec, (tuple, list)) and len(rec) == 2 and isinstance(
                    rec[1], torch.dtype):
                return build(rec, dev)
            return type(rec)(tree(v, dev) for v in rec)

        out = []
        for rec, dev in zip(self.avals, self.devices or (None,) * len(self.avals)):
            dev = torch.device(device) if device is not None else dev
            if rec[0] in ("static", "scalar"):
                out.append(rec[1])
            elif rec[0] == "tree":
                out.append(tree(rec[1], dev))
            else:
                out.append(build(rec, dev))
        return tuple(out)

    def describe(self) -> dict:
        return {
            "label": self.label,
            "kind": self.kind,
            "num_shards": self.num_shards,
            "donate_argnums": list(self.donate_argnums),
            "static_argnums": list(self.static_argnums),
            "key_argnums": list(self.key_argnums),
            "meta": dict(self.meta or {}),
            "captured": self.captured,
            "alive": self.alive,
            "calls": self.calls,
        }

    def __repr__(self) -> str:
        return (f"ProgramEntry({self.label!r}, kind={self.kind!r}, calls={self.calls}, "
                f"shapes={len(self.shapes)})")


class ProgramRegistry:
    """Bounded, thread-safe store of :class:`ProgramEntry`, registration
    order (module docstring for the lifetime rules)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: List[ProgramEntry] = []
        self._seq = itertools.count()

    def register(self, program, *, label: str, kind: str, num_shards: int = 1,
                 donate_argnums=(), static_argnums=(), key_argnums=(),
                 meta=None) -> ProgramEntry:
        """Add an entry for ``program`` (held by weakref) and return it."""
        try:
            ref = weakref.ref(program)
        except TypeError:  # an unweakrefable callable: kept (rare, as in JAX)
            ref = (lambda p=program: p)
        entry = ProgramEntry(next(self._seq), label, kind, num_shards,
                             _as_tuple(donate_argnums), meta, ref,
                             _as_tuple(static_argnums), _as_tuple(key_argnums))
        with self._lock:
            self._entries = [e for e in self._entries if e.alive]
            self._entries.append(entry)
            if len(self._entries) > self._capacity:
                del self._entries[: len(self._entries) - self._capacity]
        return entry

    def track(self, fn: Callable, *, label: str, kind: str = "compile",
              num_shards: int = 1, donate_argnums=(), static_argnums=(), key_argnums=(),
              meta: Optional[dict] = None) -> Callable:
        """Register the eager callable ``fn`` and return the wrapper to call
        in its place: it records the first positional-only call's signature,
        counts calls and goes through the dispatch profiler when one is
        enabled.  ``wrapper.program_entry`` is the entry; the entry lives as
        long as the wrapper does (it is the weakref's target)."""
        state = {"captured": False}
        guard = threading.Lock()

        def dispatch(*args, **kwargs):
            if not state["captured"]:
                with guard:
                    if not state["captured"]:
                        if not kwargs:
                            entry.capture(args)
                        state["captured"] = True
            entry.calls += 1
            prof = _profile._PROFILER
            if prof is None:
                return fn(*args, **kwargs)
            return prof.call(entry, fn, args, kwargs)

        entry = self.register(dispatch, label=label, kind=kind, num_shards=num_shards,
                              donate_argnums=donate_argnums, static_argnums=static_argnums,
                              key_argnums=key_argnums, meta=meta)
        dispatch.program_entry = entry  # type: ignore[attr-defined]
        dispatch.audit_target = fn  # type: ignore[attr-defined]
        return dispatch

    def entries(self, *, captured_only: bool = False,
                label_prefix: str = "") -> List[ProgramEntry]:
        """Live entries in registration order (a snapshot)."""
        with self._lock:
            snap = list(self._entries)
        return [e for e in snap
                if e.alive and (not captured_only or e.captured)
                and e.label.startswith(label_prefix)]

    def clear(self) -> None:
        with self._lock:
            self._entries = []

    def __len__(self) -> int:
        return len(self.entries())


_default = ProgramRegistry()
_default_lock = threading.Lock()


def default_registry() -> ProgramRegistry:
    """The process-wide registry programs register with (re-read at every
    registration: :func:`use_registry` swaps take effect at once)."""
    with _default_lock:
        return _default


@contextlib.contextmanager
def use_registry(registry: Optional[ProgramRegistry] = None):
    """Swap the process default for a scope (tests, the audit tool):
    programs built inside the ``with`` register in the scoped registry, and
    the prior default is restored on exit.  Process-global, not
    thread-local."""
    global _default
    reg = registry if registry is not None else ProgramRegistry()
    with _default_lock:
        prev, _default = _default, reg
    try:
        yield reg
    finally:
        with _default_lock:
            _default = prev
