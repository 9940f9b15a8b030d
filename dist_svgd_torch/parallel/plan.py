"""The single-device **Plan**: one compile entry point and one placement
recipe for the serving programs, with the program tracking the dispatch
profiler reads.

Counterpart of ``dist_svgd_tpu/parallel/plan.py`` (``Plan``, ``make_plan``)
in its single-device half.  Its programs register in
``dist_svgd_torch/analysis/registry.py`` (:class:`ProgramEntry`,
:class:`ProgramRegistry`, re-exported here), which the dispatch profiler
and the program auditor read.  ``make_plan(n)`` on a
host with fewer than n visible devices degrades to the single-device plan,
as JAX's does through ``make_mesh``.  The mesh half — a plan over more than
one device where that many exist, ``Plan(mesh)``, particle-sharded
placement — is not ported and raises ``NotImplementedError`` naming ROADMAP
A10.2; the port's samplers keep their own dispatch.

:meth:`Plan.compile` is the counterpart of a ``jax.jit`` trace:

- **on the card** it returns a :class:`Program` that captures one
  ``torch.cuda.CUDAGraph`` per input shape — its own static input and
  output tensors and its own memory pool.  A call copies the arguments into
  the static inputs, replays, and fetches the static outputs to the host,
  all under the graph's lock: a graph with one static input is not
  reentrant, and the serving
  batcher's lanes and the HTTP server's threads call the same program at
  once.  The capture runs on a side stream after warm-up calls, with
  ``capture_error_mode="thread_local"``, so other threads replaying other
  graphs (a hot reload captures while lanes serve) cannot break it.  A
  capture that fails raises; nothing falls back to eager;
- **on the CPU** it calls the function eagerly.

Either way a program's outputs come back as CPU tensors: its callers (the
serving engine) fetch them anyway, and the fetch is the graph's fence.

``donate_argnums`` is accepted and recorded: on the card the static input
is reused call after call, which is what donation bought in JAX; on the CPU
it does nothing.

Every program is **tracked**: a :class:`ProgramEntry` holds its label, call
count and first-call shapes and dtypes (the avals the profiler sizes rows
and bytes from), and each new input shape it sees — a graph capture on the
card — is counted.  :func:`capture_sentry` reads that count over a window,
with the hand-kernel builds in it: the counterpart of JAX's
``retrace_sentry`` that serving's steady-state contract is held to (0).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dist_svgd_torch.analysis.registry import (
    ProgramEntry,
    ProgramRegistry,
    default_registry,
    signature_of,
    use_registry,
)
from dist_svgd_torch.telemetry import profile as _profile
from dist_svgd_torch.utils.platform import resolve_device

__all__ = ["Plan", "Program", "ProgramEntry", "ProgramRegistry", "capture_sentry",
           "default_registry", "make_plan", "use_registry", "visible_devices"]

#: Warm-up calls on the capture stream before a graph is captured (first
#: calls allocate library workspaces, which a capture must not do).
WARMUP_CALLS = 2

_A10 = "ROADMAP A10.2"


# --------------------------------------------------------------------- #
# program tracking (dist_svgd_torch/analysis/registry.py)


#: Distinct argument signatures first seen by any tracked program (graph
#: captures on the card), process-wide and monotonic — what
#: :func:`capture_sentry` differences.
_captures = 0
_captures_lock = threading.Lock()


def _note_capture() -> None:
    global _captures
    with _captures_lock:
        _captures += 1


def captures_total() -> int:
    """New argument signatures seen by tracked programs since the process
    started (one CUDA-graph capture each on the card)."""
    with _captures_lock:
        return _captures


class _Sentry:
    __slots__ = ("label", "captures", "kernel_builds", "supported")

    def __init__(self, label):
        self.label = label
        self.captures = 0
        self.kernel_builds = 0
        self.supported = True

    @property
    def compiles(self) -> int:
        """Captures plus hand-kernel builds inside the window."""
        return self.captures + self.kernel_builds


@contextlib.contextmanager
def capture_sentry(label: str = "window"):
    """Count what a steady-state window must not do: new argument
    signatures of tracked programs (CUDA-graph captures on the card) and
    hand-kernel builds (``kernel_build`` events of ``ops/_build.py``).  The
    yielded object's ``compiles`` is their sum, read after the window."""
    from dist_svgd_torch.ops import _build

    sentry = _Sentry(label)
    c0, b0 = captures_total(), _build.builds_total()
    try:
        yield sentry
    finally:
        sentry.captures = captures_total() - c0
        sentry.kernel_builds = _build.builds_total() - b0


# --------------------------------------------------------------------- #
# programs


def _to_device_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a.to(device)


def _map_out(out, fn):
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(fn(v) for v in out)
    return fn(out)


#: One capture at a time in the process: captures are rare (warm-up, a
#: reload's new generation), and two of them on the allocator at once buy
#: nothing.
_CAPTURE_LOCK = threading.Lock()


class _Graph:
    """One captured CUDA graph: static inputs, static outputs, a private
    memory pool (the graph's own), and the lock held from the copy-in to
    the fetch of the outputs."""

    def __init__(self, fn: Callable, args, device: torch.device, warmup: int):
        self.lock = threading.Lock()
        self.device = device
        with _CAPTURE_LOCK, torch.cuda.device(device), torch.no_grad():
            self.static_in = [_to_device_tensor(a, device).clone() for a in args]
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(warmup):
                    fn(*self.static_in)
            stream.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.static_out = fn(*self.static_in)
                except BaseException:
                    try:  # close the broken capture; the original error is the one raised
                        self.graph.capture_end()
                    except Exception:
                        pass
                    raise
                self.graph.capture_end()
            stream.synchronize()

    def replay(self, args):
        with self.lock, torch.cuda.device(self.device):
            for s, a in zip(self.static_in, args):
                s.copy_(torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
            self.graph.replay()
            return _map_out(self.static_out, lambda t: t.to("cpu"))


class Program:
    """What :meth:`Plan.compile` returns: calls ``fn`` eagerly on the CPU;
    on the card replays one captured CUDA graph per argument signature
    (module docstring).  Every argument must be a tensor (or a numpy
    array); ``program_entry`` is its :class:`ProgramEntry`."""

    def __init__(self, fn: Callable, device: torch.device, *, label: str, kind: str,
                 donate_argnums=(), audit: Optional[dict] = None):
        self._fn = fn
        self._device = device
        self._graphs: Dict[tuple, _Graph] = {}
        self._lock = threading.RLock()
        self.program_entry = default_registry().register(
            self, label=label, kind=kind, num_shards=1, donate_argnums=donate_argnums,
            meta=audit)

    def _note_signature(self, sig) -> None:
        """Record a signature once its program exists: the first eager call
        on the CPU, the graph's capture on the card.  A call that raises
        first records nothing, so its retry is counted as the capture it is."""
        entry = self.program_entry
        with self._lock:
            if sig not in entry.shapes:
                if entry.avals is None:
                    entry.avals = sig
                    entry.devices = tuple(None if a[0] in ("static", "scalar") else
                                          self._device for a in sig)
                entry.shapes.append(sig)
                _note_capture()

    def __call__(self, *args):
        sig = signature_of(args)
        self.program_entry.calls += 1
        prof = _profile._PROFILER
        if prof is None:
            return self._run(sig, args)
        return prof.call(self.program_entry, self._run, (sig, args), {})

    def _run(self, sig, args):
        if self._device.type != "cuda":
            with torch.no_grad():
                out = self._fn(*[_to_device_tensor(a, self._device) for a in args])
            if sig not in self.program_entry.shapes:
                self._note_signature(sig)
            return out
        graph = self._graphs.get(sig)
        if graph is None:
            with self._lock:
                graph = self._graphs.get(sig)
                if graph is None:
                    graph = _Graph(self._fn, args, self._device, WARMUP_CALLS)
                    self._graphs[sig] = graph
                    self._note_signature(sig)
        return graph.replay(args)

    def audit_target(self, *args):
        """One eager call of the function on the program's device, outside
        any graph: what the auditor records (``analysis/audit.py``)."""
        with torch.no_grad():
            return self._fn(*[_to_device_tensor(a, self._device)
                              if isinstance(a, (np.ndarray, torch.Tensor)) else a
                              for a in args])

    @property
    def graphs(self) -> int:
        """CUDA graphs this program holds (0 on the CPU)."""
        return len(self._graphs)


# --------------------------------------------------------------------- #
# the plan


class Plan:
    """A compile + placement recipe bound to one device.

    Args:
        mesh: must be ``None`` — a mesh (more than one device) is ROADMAP
            A10.2's and raises ``NotImplementedError``.
        device: the plan's device; ``None`` is the card (raising without
            CUDA), ``'cpu'`` the plain eager path.
    """

    def __init__(self, mesh=None, *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Plan(mesh=...): a plan over more than one device is not ported to "
                f"PyTorch yet ({_A10})")
        self.device = resolve_device(device)

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def is_sharded(self) -> bool:
        return False

    def __repr__(self) -> str:
        return f"Plan(num_shards=1, device={self.device})"

    def describe(self) -> dict:
        """JSON-friendly identity for stats() and bench rows (JAX's keys)."""
        return {"sharded": False, "num_shards": 1, "devices": None}

    def shard_ensemble(self, particles) -> torch.Tensor:
        """Place an ``(n, d)`` ensemble on the plan's device."""
        if isinstance(particles, np.ndarray):
            particles = torch.from_numpy(particles)
        return torch.as_tensor(particles).to(self.device)

    def replicate(self, value):
        """Place a dispatch input on the plan's device (a tensor or numpy
        array; other values pass through)."""
        if isinstance(value, (np.ndarray, torch.Tensor)):
            return _to_device_tensor(value, self.device)
        return value

    def compile(self, fn: Callable, *,
                donate_argnums: Union[int, Sequence[int], Tuple] = (),
                label: Optional[str] = None, audit: Optional[dict] = None) -> Program:
        """Compile ``fn`` under this plan (module docstring): a
        :class:`Program`, tracked under ``label`` (default: ``fn``'s
        name), whose outputs come back on the host."""
        return Program(fn, self.device,
                       label=label or getattr(fn, "__name__", None) or "plan_fn",
                       kind="compile", donate_argnums=donate_argnums, audit=audit)

    def compile_sharded(self, fn: Callable, in_specs=None, out_specs=None, *,
                        donate_argnums: Union[int, Sequence[int], Tuple] = (),
                        label: Optional[str] = None, audit: Optional[dict] = None) -> Program:
        """The single-device form of JAX's ``compile_sharded``: with one
        device the specs place nothing, so this is :meth:`compile`."""
        if in_specs is not None and out_specs is None:
            raise ValueError("out_specs is required when in_specs is given")
        prog = self.compile(fn, donate_argnums=donate_argnums, label=label, audit=audit)
        prog.program_entry.kind = "compile_sharded"
        return prog


def visible_devices(device) -> int:
    """Devices a plan on ``device``'s type could span: the cards
    ``torch.cuda.device_count()`` sees, or 1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def make_plan(num_shards: Optional[int] = None, *, device=None) -> Plan:
    """A single-device :class:`Plan` on ``device``.  ``num_shards`` ``None``
    or 1, or more than the visible devices (:func:`visible_devices`), gives
    it: JAX's graceful degradation (``make_mesh`` returns ``None`` when the
    host has fewer devices than asked).  More shards where that many
    devices exist raise ``NotImplementedError`` naming ROADMAP A10.2."""
    if num_shards is not None and num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    plan = Plan(device=device)
    if num_shards is not None and 1 < num_shards <= visible_devices(plan.device):
        raise NotImplementedError(
            f"make_plan(num_shards={num_shards}): a plan over more than one device is not "
            f"ported to PyTorch yet ({_A10})")
    return plan
