"""Multi-process execution: the rendezvous, the process mesh and per-process
rows.

Counterpart of ``dist_svgd_tpu/parallel/multihost.py``.  The reference
scales past one process with a ``torch.distributed`` TCP rendezvous and an
explicit per-process rank (experiments/logreg.py:94-103,129-140 — SURVEY.md
§2.4); the port does the same: :func:`initialize` joins the group,
:func:`make_particle_mesh` lays the S shards over its W processes
granule-major — process ``r`` holds the equal contiguous run of shards
``[r·S/W, (r+1)·S/W)`` — and ``DistSampler(mesh=...)`` runs the exchange's
collectives across the processes (``parallel/mesh.py:ParticleMesh``).

The backend is chosen explicitly: NCCL for processes on the card, gloo for
the CPU, or gloo on the card when several processes share one card (NCCL
takes one rank a card; :func:`multiprocess_gap` refuses the request before
any rendezvous and names ``backend="gloo"``).  Nothing here switches backend
or device on its own.

A JAX global array built from each process's rows
(``make_array_from_process_local_data``) is, in the port, this process's
rows with their global offset and row count: :class:`GlobalRows`.
:func:`make_global_particles` builds it from :func:`process_local_rows`'s
block and :func:`host_addressable_block` takes it back apart, as JAX's do.
On a single process every function degrades to the trivial case, so a
driver is written once.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import torch

from dist_svgd_torch.parallel.mesh import GlobalRows, ParticleMesh

__all__ = [
    "GlobalRows",
    "ParticleMesh",
    "dcn_boundary_crossings",
    "host_addressable_block",
    "initialize",
    "make_global_from_local",
    "make_global_particles",
    "make_particle_mesh",
    "mesh_process_layout",
    "multiprocess_gap",
    "process_device",
    "process_local_rows",
    "replicate",
    "resolve_backend",
    "shutdown",
]

#: Seconds a rendezvous, and every later collective, may wait for a peer
#: before it raises: a crashed rank must end its peers' runs as failures.
DEFAULT_TIMEOUT_S = 120.0


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def resolve_backend(backend: Optional[str] = None, device=None) -> str:
    """The backend a group uses: ``backend`` as given, else NCCL for
    processes on the card and gloo on the CPU."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
        return backend
    kind = torch.device(device).type if device is not None else "cuda"
    return "nccl" if kind == "cuda" else "gloo"


def process_device(local_rank: int, device=None) -> torch.device:
    """A process's device: ``cpu`` when asked, else ``cuda:(local_rank mod
    cards)`` — several processes share a card when there are fewer cards
    than processes.  No card raises (never a quiet CPU run)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' for a CPU process")
    return torch.device("cuda", int(local_rank) % torch.cuda.device_count())


def multiprocess_gap(num_processes: Optional[int] = None, backend: Optional[str] = None,
                     device=None, local_processes: Optional[int] = None) -> Optional[str]:
    """One-line reason a ``num_processes``-way group cannot work here, or
    ``None`` when it can — checked before any rendezvous.  ``device`` is the
    processes' device kind (the card by default), ``local_processes`` how
    many of them run on this host (all of them by default: nothing here
    tells a program of other hosts)."""
    if num_processes is None or num_processes <= 1:
        return None
    dist = _dist()
    if not dist.is_available():
        return "torch.distributed is not available in this torch build"
    backend = resolve_backend(backend, device)
    on_card = torch.device(device).type == "cuda" if device is not None else True
    if backend == "gloo":
        if not dist.is_gloo_available():
            return "the gloo backend is not available in this torch build"
        if on_card and not torch.cuda.is_available():
            return "the processes' device is the card, but CUDA is not available"
        return None
    local = int(local_processes if local_processes is not None else num_processes)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not on_card:
        return "backend='nccl' runs on the card only: pass backend=\"gloo\" for CPU processes"
    if local > cards:
        return (f"NCCL takes one rank a card, and {local} ranks on this host have "
                f"{cards} card(s) ('Duplicate GPU detected'): pass backend=\"gloo\" to "
                "run several processes on one card")
    if not dist.is_nccl_available():
        return "NCCL is not available in this torch build: pass backend=\"gloo\""
    return None


def _parse_address(address: str) -> Tuple[str, int]:
    host, sep, port = str(address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not HOST:PORT")
    return host, int(port)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device=None) -> bool:
    """Join a ``num_processes``-process group as rank ``process_id`` over
    ``tcp://coordinator_address`` — the reference's
    ``dist.init_process_group`` rendezvous (experiments/logreg.py:96).

    Idempotent: returns ``False`` when the group already exists, and for a
    plainly single-process run (no coordinator and at most one process);
    ``True`` when this call joined.  A request :func:`multiprocess_gap`
    refuses raises ``RuntimeError`` before any rendezvous; a coordinator
    that cannot be honoured (malformed, or no peer within ``timeout_s``)
    raises.  ``timeout_s`` also bounds every later collective, so a peer's
    death ends this process's run as an error, not a hang."""
    if _initialized():
        return False
    if coordinator_address is None:
        if num_processes is not None and num_processes > 1:
            raise ValueError(f"a {num_processes}-process group needs a coordinator address")
        return False
    host, port = _parse_address(coordinator_address)
    W = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < W:
        raise ValueError(f"process_id {rank} not in [0, {W})")
    gap = multiprocess_gap(W, backend, device)
    if gap is not None:
        raise RuntimeError(gap)
    dist = _dist()
    try:
        dist.init_process_group(
            resolve_backend(backend, device), init_method=f"tcp://{host}:{port}",
            world_size=W, rank=rank, timeout=datetime.timedelta(seconds=float(timeout_s)))
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(
            f"initialize({coordinator_address=}, {num_processes=}, {process_id=}) "
            f"failed: {e}") from e
    return True


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    if _initialized():
        _dist().destroy_process_group()


def make_particle_mesh(num_shards: Optional[int] = None, device=None) -> ParticleMesh:
    """The 1-D particle mesh over every process of the group, granule-major:
    process ``r`` holds shards ``[r·S/W, (r+1)·S/W)``, so a ring hop crosses
    a process boundary W times, the minimum.  ``num_shards`` defaults to
    one shard a process and must be a positive multiple of the process
    count (a process without shards would fail far from here).  ``device``
    is the process's device (:func:`process_device` by default).  Without a
    group it is the single-process emulation."""
    if not _initialized():
        S = 1 if num_shards is None else int(num_shards)
        return ParticleMesh(S, device=None if device is None else torch.device(device))
    dist = _dist()
    W, rank = dist.get_world_size(), dist.get_rank()
    S = W if num_shards is None else int(num_shards)
    if S < W or S % W:
        raise ValueError(f"need a positive multiple of the {W} processes' count of shards, "
                         f"got {S}")
    dev = process_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's device for this rank
    return ParticleMesh(S, world_size=W, rank=rank, device=dev,
                        backend=str(dist.get_backend()), distributed=True)


def process_local_rows(n_global: int, mesh: ParticleMesh) -> Tuple[int, int]:
    """``(start, count)`` of the global rows this process's shards own — the
    reference's per-rank ``rank · particles_per_shard`` ownership
    (dsvgd/distsampler.py:46-49).  Rows that do not divide the shards
    raise: a ragged block would break the row accounting of the saves."""
    n = int(n_global)
    if n % mesh.num_shards:
        raise ValueError(f"{n} rows are not divisible into {mesh.num_shards} shards")
    per = n // mesh.num_shards
    return mesh.first_shard * per, mesh.shards_per_process * per


def make_global_from_local(local, mesh: ParticleMesh, global_shape) -> GlobalRows:
    """The global array of ``global_shape`` from this process's axis-0 block
    (:func:`process_local_rows` of ``global_shape[0]``) — for arrays of any
    rank, as the W2 snapshot stack.  On one process the block must be the
    whole array."""
    local = torch.as_tensor(local)
    global_shape = tuple(int(v) for v in global_shape)
    start, count = process_local_rows(global_shape[0], mesh)
    want = (count, *global_shape[1:])
    if tuple(local.shape) != want:
        what = "single-process local block" if not mesh.multiprocess else "local block"
        raise ValueError(f"{what} {tuple(local.shape)} != {want} (rows {start}.."
                         f"{start + count} of the global {global_shape})")
    return GlobalRows(local, start, global_shape[0])


def make_global_particles(local_rows, mesh: ParticleMesh,
                          n_global: Optional[int] = None) -> GlobalRows:
    """The global ``(n, d)`` particle array from this process's block of rows
    (:func:`process_local_rows` says which).  ``n_global`` defaults to equal
    blocks over the processes; on one process it must be the block's rows."""
    local_rows = torch.as_tensor(local_rows)
    if n_global is None:
        n_global = local_rows.shape[0] * mesh.process_count
    elif not mesh.multiprocess and n_global != local_rows.shape[0]:
        raise ValueError(f"n_global {n_global} != local rows {local_rows.shape[0]} on a "
                         "single-process run")
    return make_global_from_local(local_rows, mesh, (n_global, *local_rows.shape[1:]))


def host_addressable_block(arr, axis: int = 0) -> Tuple[np.ndarray, int]:
    """``(rows, start)``: a host copy of this process's rows of a global
    array, and their first global row; the whole array and 0 for a tensor or
    a numpy array (one process holds it all)."""
    if axis != 0:
        raise ValueError("global arrays are split along axis 0 only")
    if isinstance(arr, GlobalRows):
        return arr.rows.detach().cpu().numpy(), int(arr.start)
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy(), 0
    return np.asarray(arr), 0


def replicate(value, mesh: ParticleMesh) -> torch.Tensor:
    """The whole value on this process's device (every process loads it: the
    reference's every-rank-loads-the-full-dataset, experiments/logreg.py:28)."""
    return torch.as_tensor(np.asarray(value), device=mesh.device)


def mesh_process_layout(mesh: ParticleMesh) -> Tuple[int, Tuple[int, ...]]:
    """``(process_count, per-process shard counts)``: the layout the
    topology manifest stamps, identical in every process."""
    return mesh.process_count, (mesh.shards_per_process,) * mesh.process_count


def dcn_boundary_crossings(mesh_or_processes) -> int:
    """How many ring-adjacent shard pairs (wrap included) sit in different
    processes: the process boundaries one ring hop crosses.  Takes a mesh
    (W for W > 1, 0 for one process) or the process of each shard in ring
    order (ints, or objects with ``process_index``)."""
    if isinstance(mesh_or_processes, ParticleMesh):
        W = mesh_or_processes.process_count
        return W if W > 1 else 0
    procs = [getattr(p, "process_index", p) for p in mesh_or_processes]
    if len(procs) < 2:
        return 0
    return sum(procs[i] != procs[(i + 1) % len(procs)] for i in range(len(procs)))
