"""The **Plan**: one compile entry point and one placement recipe for the
serving programs, over one device or a 1-D device mesh, with the program
tracking the dispatch profiler reads.

Counterpart of ``dist_svgd_tpu/parallel/plan.py`` (``Plan``, ``make_plan``,
``nondividing_replicate_warning``).  Its programs register in
``dist_svgd_torch/analysis/registry.py`` (:class:`ProgramEntry`,
:class:`ProgramRegistry`, re-exported here), which the dispatch profiler
and the program auditor read.

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

**The mesh.**  A :class:`Mesh` is a 1-D tuple of torch devices on the axis
:data:`AXIS`, and a device may repeat: ``Mesh(['cpu'] * 8)`` or
``Mesh(['cuda:0'] * 4)`` is the port's form of XLA's
``--xla_force_host_platform_device_count`` — several logical devices on
one physical one, which is how JAX's own tests build their 8-device mesh and
how a one-card host runs a sharded plan at all.  A host with n cards gets
``cuda:0 … cuda:n-1`` from :func:`make_plan`.  A plan over a mesh
(``Plan(mesh)``) places an ensemble as one contiguous row block on each mesh
device (:meth:`Plan.shard_ensemble`, JAX's ``P(AXIS, None)``; a row count
the mesh does not divide is replicated, with
:func:`nondividing_replicate_warning`'s text), and compiles a **mesh
program** from a per-shard partial function and a combine
(:class:`MeshProgram`): the partials run on their shards' devices, the
combine on the mesh's first device, and one fetch to the host ends the
call.  On the card one graph per (physical device, input shape) covers that
device's shards — on a one-card mesh one graph holds every shard and the
combine; across cards the other devices' partials are copied into the
first device's graph's static inputs.  Where JAX compiles one function and
XLA partitions its particle-axis reduction into a ``psum``, the port's
caller writes the partial and the combine itself (``serving/engine.py``).
``compile_sharded`` has no mesh form here: the port's samplers shard
through their in-process lanes and ``ParticleMesh`` (``parallel/mesh.py``).

``donate_argnums`` is accepted and recorded: on the card the static input
is reused call after call, which is what donation bought in JAX; on the CPU
it does nothing.

Every program is **tracked**: a :class:`ProgramEntry` holds its label, call
count, shard count and first-call shapes and dtypes (the avals the profiler
sizes rows and bytes from), and each new input shape it sees — one graph
capture per device on the card — is counted once.  :func:`capture_sentry`
reads that count over a window, with the hand-kernel builds in it: the
counterpart of JAX's ``retrace_sentry`` that serving's steady-state
contract is held to (0).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

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

__all__ = ["AXIS", "CAPTURE_PARTS", "Mesh", "MeshProgram", "Plan", "Program", "ProgramEntry",
           "ProgramRegistry", "ShardedEnsemble", "Sharding", "capture_parts", "capture_sentry",
           "default_registry", "ensemble_tensor", "make_plan",
           "nondividing_replicate_warning", "use_registry", "visible_devices"]

#: Warm-up calls on the capture stream before a graph is captured (first
#: calls allocate library workspaces, which a capture must not do).
WARMUP_CALLS = 2

#: Name of the particle-sharding mesh axis (JAX's ``parallel/mesh.py:AXIS``).
AXIS = "shards"


def nondividing_replicate_warning(n: int, num_shards: int) -> str:
    """The ONE warning text for the replicate-instead-of-shard fallback:
    :meth:`Plan.shard_ensemble` at engine construction and
    ``utils/checkpoint.py:reshard_state`` on an elastic resume to a shard
    count that does not divide the particle count (JAX's text)."""
    return (
        f"ensemble of {n} particles is not divisible by "
        f"{num_shards} shards; replicating instead of sharding "
        "(serving stays correct, the mesh win is lost)"
    )


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


def _placed(args, device: torch.device) -> list:
    """Tensors and numpy arrays of ``args`` on ``device``; other values
    as they are."""
    return [_to_device_tensor(a, device) if isinstance(a, (np.ndarray, torch.Tensor)) else a
            for a in args]


def _map_out(out, fn):
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(fn(v) for v in out)
    return fn(out)


def _fetch(out):
    return _map_out(out, lambda t: t.to("cpu"))


#: One capture at a time in the process: captures are rare (warm-up, a
#: reload's new generation), and two of them on the allocator at once buy
#: nothing.
_CAPTURE_LOCK = threading.Lock()

#: What a capture spends, in order: the wait for :data:`_CAPTURE_LOCK`, the
#: warm-up calls, the capture.
CAPTURE_PARTS = ("lock_wait_s", "warmup_s", "capture_s")

#: The calling thread's open :func:`capture_parts` record (a reload captures
#: on its own thread while lanes serve).
_PARTS = threading.local()


@contextlib.contextmanager
def capture_parts():
    """Sum, over every CUDA-graph capture this thread makes inside the
    block, the seconds of each of :data:`CAPTURE_PARTS`, with the count of
    captures (``captures``).  Yields the dict, filled as captures end; an
    inner block takes the captures made inside it."""
    parts = dict.fromkeys(CAPTURE_PARTS, 0.0)
    parts["captures"] = 0
    outer = getattr(_PARTS, "record", None)
    _PARTS.record = parts
    try:
        yield parts
    finally:
        _PARTS.record = outer


def _note_capture_parts(*stamps) -> None:
    record = getattr(_PARTS, "record", None)
    if record is None:
        return
    for name, a, b in zip(CAPTURE_PARTS, stamps, stamps[1:]):
        record[name] += b - a
    record["captures"] += 1


def _capture(graph, stream, fn, args):
    """``fn(*args)`` captured into ``graph`` on ``stream``; returns the
    static outputs.  The cyclic collector is off for the capture and back
    as it was after it, also when the capture fails: a collection inside it
    that frees a dropped program's graph resets that graph on the capturing
    thread, which the capture refuses (cudaErrorStreamCaptureInvalidated)."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*args)
            except BaseException:
                try:  # close the broken capture; the original error is the one raised
                    graph.capture_end()
                except Exception:
                    pass
                raise
            graph.capture_end()
        return out
    finally:
        if collecting:
            gc.enable()


class _Graph:
    """One captured CUDA graph: static inputs, static outputs and a private
    memory pool (the graph's own).  :meth:`run` copies in and replays; its
    caller holds the lock that covers the copy-in, the replay and the fetch
    of the outputs.  Its parts' seconds go to the thread's
    :func:`capture_parts` record."""

    def __init__(self, fn: Callable, args, device: torch.device, warmup: int):
        self.lock = threading.Lock()
        self.device = device
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, torch.cuda.device(device), torch.no_grad():
            t1 = time.perf_counter()
            self.static_in = [_to_device_tensor(a, device).clone() for a in args]
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for _ in range(warmup):
                    fn(*self.static_in)
            stream.synchronize()
            t2 = time.perf_counter()
            # no full collection first (torch.cuda.graph's is opt-in for its
            # cost): it scans the whole heap at every capture, and only a
            # collection inside the capture harms it
            self.graph = torch.cuda.CUDAGraph()
            self.static_out = _capture(self.graph, stream, fn, self.static_in)
            stream.synchronize()
            t3 = time.perf_counter()
        _note_capture_parts(t0, t1, t2, t3)

    def run(self, args):
        """Copy ``args`` into the static inputs (a copy from another card
        is a peer copy, fenced on both cards' streams) and replay; returns
        the static outputs, valid until the next replay."""
        with torch.cuda.device(self.device):
            for s, a in zip(self.static_in, args):
                s.copy_(torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
            self.graph.replay()
        return self.static_out

    def replay(self, args):
        with self.lock:
            return _fetch(self.run(args))


class Program:
    """What :meth:`Plan.compile` returns: calls ``fn`` eagerly on the CPU;
    on the card replays one captured CUDA graph per argument signature
    (module docstring).  Every argument must be a tensor (or a numpy
    array); ``program_entry`` is its :class:`ProgramEntry`."""

    def __init__(self, fn: Optional[Callable], device: torch.device, *, label: str, kind: str,
                 num_shards: int = 1, donate_argnums=(), audit: Optional[dict] = None):
        self._fn = fn
        self._device = device
        self._graphs: Dict[tuple, object] = {}
        self._lock = threading.RLock()
        self.program_entry = default_registry().register(
            self, label=label, kind=kind, num_shards=num_shards,
            donate_argnums=donate_argnums, meta=audit)

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

    def _eager(self, args):
        return self._fn(*_placed(args, self._device))

    def _capture(self, args):
        return _Graph(self._fn, args, self._device, WARMUP_CALLS)

    def _run(self, sig, args):
        if self._device.type != "cuda":
            with torch.no_grad():
                out = self._eager(args)
            if sig not in self.program_entry.shapes:
                self._note_signature(sig)
            return out
        graph = self._graphs.get(sig)
        if graph is None:
            with self._lock:
                graph = self._graphs.get(sig)
                if graph is None:
                    graph = self._capture(args)
                    self._graphs[sig] = graph
                    self._note_signature(sig)
        return graph.replay(args)

    def audit_target(self, *args):
        """One eager call of the function on the program's device, outside
        any graph: what the auditor records (``analysis/audit.py``)."""
        with torch.no_grad():
            return self._eager(args)

    @property
    def graphs(self) -> int:
        """CUDA graphs this program holds (0 on the CPU)."""
        return len(self._graphs)


class _MeshGraphs:
    """The graphs of one input shape of a :class:`MeshProgram`: one per
    physical device, the first device's holding its shards' partials and
    the combine, and one lock over the copy-in, every replay and the fetch."""

    def __init__(self, prog: "MeshProgram", args):
        self.lock = threading.Lock()
        (dev0, _), *others = prog._groups
        self.others: List[_Graph] = [
            _Graph(prog._group_fn(idx), args, dev, WARMUP_CALLS) for dev, idx in others]
        recv = [t for g in self.others for part in g.static_out for t in part]
        self.first = _Graph(prog._first_fn(len(args)), list(args) + recv, dev0, WARMUP_CALLS)

    @property
    def graph(self):
        """The first device's graph (one-card meshes have no other)."""
        return self.first.graph

    def replay(self, args):
        with self.lock:
            recv = [t for g in self.others for part in g.run(args) for t in part]
            return _fetch(self.first.run(list(args) + recv))


class MeshProgram(Program):
    """What :meth:`Plan.compile` returns over a mesh given ``combine=``:
    ``partial(block, *args)`` — a tuple of tensors — runs on each shard's
    device against that shard's row block of ``ensemble``, and
    ``combine(parts)`` on the mesh's first device takes the S partials in
    mesh order, moved there, and returns the outputs.  Eager on the CPU; on
    the card one CUDA graph per (physical device, input shape), captured
    as :class:`Program` captures, the first device's holding the combine
    (module docstring).  The entry records the mesh's shard count."""

    def __init__(self, partial: Callable, combine: Callable, ensemble: "ShardedEnsemble", *,
                 label: str, donate_argnums=(), audit: Optional[dict] = None):
        mesh = ensemble.mesh
        super().__init__(None, mesh.devices[0], label=label, kind="compile",
                         num_shards=len(mesh.devices), donate_argnums=donate_argnums,
                         audit=audit)
        self._partial = partial
        self._combine = combine
        self._blocks = ensemble.blocks
        groups: Dict[torch.device, List[int]] = {}
        for i, dev in enumerate(mesh.devices):
            groups.setdefault(dev, []).append(i)
        #: (device, shard indices) by physical device, the first device first.
        self._groups: List[Tuple[torch.device, List[int]]] = list(groups.items())
        #: Shards of the other devices, in the order their partials arrive.
        self._remote = [i for _, idx in self._groups[1:] for i in idx]

    def _group_fn(self, idx):
        def run(*args):
            return [self._partial(self._blocks[i], *args) for i in idx]
        return run

    def _first_fn(self, n_args: int):
        (_, own), remote = self._groups[0], self._remote

        def run(*args):
            xs, recv = args[:n_args], list(args[n_args:])
            parts = {i: self._partial(self._blocks[i], *xs) for i in own}
            if remote:
                k = len(recv) // len(remote)
                for j, i in enumerate(remote):
                    parts[i] = tuple(recv[j * k:(j + 1) * k])
            return self._combine([parts[i] for i in range(len(parts))])
        return run

    def _eager(self, args):
        dev0 = self._device
        parts = {}
        for dev, idx in self._groups:
            dargs = _placed(args, dev)
            for i in idx:
                parts[i] = tuple(t.to(dev0) for t in self._partial(self._blocks[i], *dargs))
        return self._combine([parts[i] for i in range(len(parts))])

    def _capture(self, args):
        return _MeshGraphs(self, args)

    @property
    def graphs(self) -> int:
        """CUDA graphs this program holds (0 on the CPU): one per physical
        device and input shape."""
        return len(self._graphs) * len(self._groups)


# --------------------------------------------------------------------- #
# the mesh and placement


class Mesh:
    """A 1-D device mesh: ``devices``, a tuple of torch devices on the one
    axis ``axis_names[0]`` (a plan takes only :data:`AXIS`).  Devices may
    repeat (module docstring); they must share one type."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = (AXIS,)):
        devs = []
        for d in devices:
            d = torch.device(d)
            devs.append(torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(tuple(axis_names)) != 1:
            raise ValueError(f"a plan mesh is 1-D, got axes {tuple(axis_names)}")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh's devices share one type, got {devs}")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


class Sharding(NamedTuple):
    """A placement on a mesh: ``spec`` is JAX's ``PartitionSpec`` as a
    tuple — ``(AXIS, None)`` for particle rows split, ``()`` replicated."""

    mesh: Mesh
    spec: tuple


class ShardedEnsemble:
    """An ensemble placed on a mesh: ``blocks[i]`` lives on
    ``mesh.devices[i]`` — contiguous row block i of the global array under
    ``(AXIS, None)``, the whole array under the replicated spec ``()``.
    ``shape`` and ``dtype`` are the global array's; :meth:`gather` and
    :meth:`numpy` give it back in one piece."""

    __slots__ = ("sharding", "blocks", "shape", "dtype")

    def __init__(self, blocks: Sequence[torch.Tensor], sharding: Sharding, shape):
        self.sharding = sharding
        self.blocks = tuple(blocks)
        self.shape = torch.Size(shape)
        self.dtype = self.blocks[0].dtype

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where the combine runs)."""
        return self.blocks[0].device

    @property
    def is_sharded(self) -> bool:
        return bool(self.spec)

    def dim(self) -> int:
        return len(self.shape)

    def gather(self, device=None) -> torch.Tensor:
        """The global array as one tensor on ``device`` (default the mesh's
        first device)."""
        dev = self.device if device is None else torch.device(device)
        if not self.is_sharded:
            return self.blocks[0].to(dev)
        return torch.cat([b.to(dev) for b in self.blocks])

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedEnsemble(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, shards={len(self.blocks)})")


def ensemble_tensor(particles) -> torch.Tensor:
    """An ensemble as one tensor: a :class:`ShardedEnsemble` gathered on its
    mesh's first device, a tensor as it is, anything else through numpy."""
    if isinstance(particles, ShardedEnsemble):
        return particles.gather()
    if isinstance(particles, torch.Tensor):
        return particles
    return torch.from_numpy(np.asarray(particles))


# --------------------------------------------------------------------- #
# the plan


class Plan:
    """A compile + placement recipe bound to one device or a device mesh.

    Args:
        mesh: a 1-D :class:`Mesh` on :data:`AXIS` (``ValueError`` for
            another axis), or ``None`` for one device.  Build one with
            :func:`make_plan` or by hand, devices repeating where one
            device stands for several.
        device: the single-device plan's device; ``None`` is the card
            (raising without CUDA), ``'cpu'`` the plain eager path.  With a
            mesh the plan's device is the mesh's first.
    """

    def __init__(self, mesh: Optional[Mesh] = None, *, device=None):
        if mesh is None:
            self.mesh = None
            self.device = resolve_device(device)
            return
        if AXIS not in mesh.axis_names:
            raise ValueError(f"plan mesh must carry the {AXIS!r} axis, got {mesh.axis_names}")
        for dev in dict.fromkeys(mesh.devices):
            resolve_device(dev)
        if device is not None and torch.device(device).type != mesh.devices[0].type:
            raise ValueError(f"device {device} is not the mesh's {mesh.devices[0]}")
        self.mesh = mesh
        self.device = mesh.devices[0]

    @property
    def num_shards(self) -> int:
        """Devices on the particle axis (1 when single-device)."""
        return self.mesh.shape[AXIS] if self.mesh is not None else 1

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    def __repr__(self) -> str:
        return f"Plan(num_shards={self.num_shards}, device={self.device})"

    def describe(self) -> dict:
        """JSON-friendly identity for stats() and bench rows (JAX's keys)."""
        return {"sharded": self.is_sharded, "num_shards": self.num_shards,
                "devices": ([str(d) for d in self.mesh.devices]
                            if self.mesh is not None else None)}

    # -- shardings ---------------------------------------------------------

    def replicated(self) -> Optional[Sharding]:
        """Every-device-sees-everything placement; ``None`` without a mesh."""
        return None if self.mesh is None else Sharding(self.mesh, ())

    def particle_sharding(self, ndim: int = 2) -> Optional[Sharding]:
        """Leading-axis (particle) sharding for an ``ndim``-dim array."""
        if self.mesh is None:
            return None
        return Sharding(self.mesh, (AXIS,) + (None,) * (ndim - 1))

    def spec_sharding(self, spec: Optional[int]) -> Optional[Sharding]:
        """Sharding for one ``bind_shard_fn``-style spec entry: ``None`` →
        replicated, an int ``s`` → split along axis ``s``; ``None`` without
        a mesh."""
        if self.mesh is None:
            return None
        if spec is None:
            return self.replicated()
        return Sharding(self.mesh, (None,) * spec + (AXIS,))

    # -- placement ---------------------------------------------------------

    def shard_ensemble(self, particles):
        """Place an ``(n, d)`` ensemble: on the plan's device without a
        mesh (a tensor); over a mesh a :class:`ShardedEnsemble`, split along
        the particle axis, or replicated with
        :func:`nondividing_replicate_warning`'s warning when the mesh does
        not divide n."""
        arr = ensemble_tensor(particles)
        if self.mesh is None:
            return arr.to(self.device)
        if arr.dim() == 0:
            raise ValueError("an ensemble needs a particle axis, got a scalar")
        devs, S = self.mesh.devices, self.num_shards
        if arr.shape[0] % S:
            warnings.warn(nondividing_replicate_warning(arr.shape[0], S), UserWarning,
                          stacklevel=2)
            return ShardedEnsemble([arr.to(d) for d in devs], self.replicated(), arr.shape)
        rows = arr.shape[0] // S
        return ShardedEnsemble([arr[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(devs)],
                               self.particle_sharding(arr.dim()), arr.shape)

    def replicate(self, value):
        """Place a dispatch input on the plan's device — over a mesh its
        first device, from which a mesh program copies it to each shard's
        device (a tensor or numpy array; other values pass through)."""
        if isinstance(value, (np.ndarray, torch.Tensor)):
            return _to_device_tensor(value, self.device)
        return value

    # -- compile -----------------------------------------------------------

    def compile(self, fn: Callable, *, combine: Optional[Callable] = None,
                ensemble: Optional[ShardedEnsemble] = None,
                donate_argnums: Union[int, Sequence[int], Tuple] = (),
                label: Optional[str] = None, audit: Optional[dict] = None) -> Program:
        """Compile ``fn`` under this plan (module docstring), tracked under
        ``label`` (default: ``fn``'s name); outputs come back on the host.

        Without ``combine`` this is a :class:`Program` of ``fn`` on the
        plan's device — over a mesh its first device, the replicated
        placement's program.  With ``combine`` (a mesh plan only) ``fn`` is
        the per-shard partial over ``ensemble``'s row blocks and the result
        a :class:`MeshProgram`."""
        label = label or getattr(fn, "__name__", None) or "plan_fn"
        if combine is None:
            if ensemble is not None:
                raise ValueError("ensemble= goes with combine=")
            return Program(fn, self.device, label=label, kind="compile",
                           num_shards=self.num_shards, donate_argnums=donate_argnums,
                           audit=audit)
        if self.mesh is None:
            raise ValueError("combine= needs a plan over a mesh")
        if ensemble is None or ensemble.mesh is not self.mesh or not ensemble.is_sharded:
            raise ValueError("combine= needs an ensemble sharded on this plan's mesh")
        return MeshProgram(fn, combine, ensemble, label=label,
                           donate_argnums=donate_argnums, audit=audit)

    def compile_sharded(self, fn: Callable, in_specs=None, out_specs=None, *,
                        donate_argnums: Union[int, Sequence[int], Tuple] = (),
                        label: Optional[str] = None, audit: Optional[dict] = None) -> Program:
        """The single-device form of JAX's ``compile_sharded``: with one
        device the specs place nothing, so this is :meth:`compile`.  Over a
        mesh it raises ``ValueError``: its JAX callers are ``DistSampler``'s
        ``bind_shard_fn`` programs, and the port's samplers shard through
        their in-process lanes and ``ParticleMesh`` instead (by design)."""
        if self.mesh is not None:
            raise ValueError(
                "compile_sharded over a mesh has no port counterpart: the port's samplers "
                "shard through their in-process lanes and ParticleMesh (parallel/mesh.py)")
        if in_specs is not None and out_specs is None:
            raise ValueError("out_specs is required when in_specs is given")
        prog = self.compile(fn, donate_argnums=donate_argnums, label=label, audit=audit)
        prog.program_entry.kind = "compile_sharded"
        return prog


def visible_devices(device) -> int:
    """Devices a plan on ``device``'s type could span: the cards
    ``torch.cuda.device_count()`` sees, or 1 for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def make_plan(num_shards: Optional[int] = None, devices: Optional[Sequence] = None, *,
              device=None) -> Plan:
    """A :class:`Plan` over ``num_shards`` of ``devices`` (JAX's signature).

    ``devices=None`` is the visible devices of ``device``'s type
    (:func:`visible_devices`): ``cuda:0 … cuda:k-1``, or the one ``cpu``
    repeated k times.  ``num_shards=None`` uses them all.  One shard, or
    more than ``devices`` holds, gives the single-device plan: JAX's
    graceful degradation (``make_mesh`` returns ``None``).  An explicit
    ``devices`` list builds the mesh as given, repeats included."""
    if devices is None:
        dev = resolve_device(device)
        k = visible_devices(dev)
        devices = ([torch.device("cuda", i) for i in range(k)] if dev.type == "cuda"
                   else [dev] * k)
    else:
        devices = list(devices)
        if device is None and devices:
            device = devices[0]
    if num_shards is None:
        num_shards = len(devices)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards == 1 or len(devices) < num_shards:
        return Plan(device=device)
    return Plan(Mesh(devices[:num_shards]))
