"""The particle mesh: S shards over W processes.

Counterpart of ``dist_svgd_tpu/parallel/mesh.py``.  The S shards of a
sampler are a leading lane axis of its ``(L, n/S, ...)`` block stack; a
:class:`ParticleMesh` says which run of the S global shards this process
holds (``L = S/W`` of them, from :attr:`ParticleMesh.first_shard`: the
granule-major contract of ``dist_svgd_tpu/parallel/multihost.py:
make_particle_mesh``) and carries the three collectives of the exchange:

- :meth:`ParticleMesh.all_gather` — every process's local blocks into the
  global ``(n, ...)`` set;
- :meth:`ParticleMesh.psum` — a sum over all S shards: over the local lanes,
  then ``all_reduce`` across processes;
- :meth:`ParticleMesh.roll` — JAX's ``ppermute`` by ±1 over the global shard
  axis: a local roll plus one send/recv pair at each process boundary.

A single-process mesh (W = 1) is the emulation of the JAX package's
``vmap(axis_name=...)`` backend, bit for bit: every lane is local and the
collectives are the module functions below (:func:`all_gather` is
:func:`merge`, :func:`psum` a sum over the lane axis, the roll
``torch.roll``).  A W-process mesh (``multihost.make_particle_mesh``) runs
them over ``torch.distributed``.  Under the gloo backend with blocks on the
card every collective copies its block to the host and back (gloo's
send/recv takes host tensors only): the copy is written in the collective
itself, and :attr:`ParticleMesh.staged_bytes` counts it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def split(a: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``(n, ...)`` → ``(S, n/S, ...)`` contiguous blocks (a view)."""
    if a.shape[0] % num_shards:
        raise ValueError(f"{a.shape[0]} rows do not split into {num_shards} shards")
    return a.reshape(num_shards, a.shape[0] // num_shards, *a.shape[1:])


def merge(blocks: torch.Tensor) -> torch.Tensor:
    """``(S, b, ...)`` → ``(S·b, ...)``: the inverse of :func:`split`."""
    return blocks.reshape(blocks.shape[0] * blocks.shape[1], *blocks.shape[2:])


def all_gather(blocks: torch.Tensor) -> torch.Tensor:
    """Every shard's view of the gathered set: the global array."""
    return merge(blocks)


def psum(per_shard: torch.Tensor) -> torch.Tensor:
    """Sum over the shard axis."""
    return torch.sum(per_shard, dim=0)


@dataclass(frozen=True)
class GlobalRows:
    """This process's rows of a global ``(n_global, ...)`` array: the port's
    form of a JAX global array built by ``make_array_from_process_local_data``
    — ``rows`` are the global rows ``[start, start + len(rows))``."""

    rows: torch.Tensor
    start: int
    n_global: int

    @property
    def shape(self) -> tuple:
        """The global array's shape."""
        return (self.n_global, *self.rows.shape[1:])


class ParticleMesh:
    """A 1-D mesh of ``num_shards`` particle shards over the processes of a
    ``torch.distributed`` group, each process holding an equal contiguous
    run of shards.

    The default (one process, no group) is the single-process emulation.
    :func:`dist_svgd_torch.parallel.multihost.make_particle_mesh` builds the
    mesh of a rendezvous (``distributed=True``): its collectives run on
    ``torch.distributed``'s default group, at W = 1 too (an ``all_gather``
    of one part and an ``all_reduce`` of one rank return their input, so a
    one-process group gives the emulation's values).  The counters
    (:meth:`counts`) say what the collectives moved: ``collectives`` (calls
    that crossed processes), ``sends`` (this process's ring sends, one per
    process boundary a rotation crosses) and ``staged_bytes`` (bytes copied
    through host memory for the gloo backend)."""

    def __init__(self, num_shards: int, world_size: int = 1, rank: int = 0,
                 device=None, backend: Optional[str] = None, distributed: bool = False):
        S, W = int(num_shards), int(world_size)
        if S < 1 or W < 1:
            raise ValueError(f"need num_shards >= 1 and world_size >= 1, got {S}, {W}")
        if S % W:
            raise ValueError(f"num_shards {S} must be a multiple of the {W} processes "
                             "(each process holds an equal run of shards)")
        if not 0 <= int(rank) < W:
            raise ValueError(f"rank {rank} not in [0, {W})")
        self.num_shards = S
        self.world_size = W
        self.rank = int(rank)
        self.shards_per_process = S // W
        self.first_shard = self.rank * self.shards_per_process
        self.device = None if device is None else torch.device(device)
        self.backend = backend
        if W > 1 and not distributed:
            raise ValueError("a mesh over several processes runs its collectives on "
                             "torch.distributed: pass distributed=True after the rendezvous")
        self.distributed = bool(distributed)
        # gloo takes host tensors in send/recv: blocks on the card go through
        # host memory, in every collective (never a quiet switch on failure)
        self._stage = (self.distributed and backend == "gloo" and self.device is not None
                       and self.device.type == "cuda")
        self.reset_counts()

    @property
    def process_count(self) -> int:
        return self.world_size

    @property
    def multiprocess(self) -> bool:
        return self.world_size > 1

    @property
    def stages_through_host(self) -> bool:
        """Whether the collectives copy blocks through host memory (gloo
        with blocks on the card)."""
        return self._stage

    def reset_counts(self) -> None:
        self.collectives = 0
        self.sends = 0
        self.staged_bytes = 0

    def counts(self) -> dict:
        return {"collectives": self.collectives, "sends": self.sends,
                "staged_bytes": self.staged_bytes}

    def lanes(self, device) -> torch.Tensor:
        """Global shard index of each local lane."""
        return torch.arange(self.first_shard, self.first_shard + self.shards_per_process,
                            device=device)

    def local_lanes(self, a):
        """The local lanes ``[first, first + L)`` of a tensor laid out over all
        S shards along axis 0 (the whole tensor on a single process)."""
        if not self.multiprocess:
            return a
        return a[self.first_shard:self.first_shard + self.shards_per_process]

    # -- transport ---------------------------------------------------- #

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor about to enter a collective, on the host when staged."""
        if self._stage:
            self.staged_bytes += t.numel() * t.element_size()
            return t.detach().cpu()
        return t.contiguous()

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A collective's result back on the blocks' device when staged."""
        if self._stage:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    # -- collectives -------------------------------------------------- #

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """``(L, ...)`` local lanes → ``(S, ...)`` all lanes in global order."""
        if not self.distributed:
            return x
        import torch.distributed as dist

        src = self._out(x)
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        self.collectives += 1
        return self._back(torch.cat(parts), x)

    def all_gather(self, blocks: torch.Tensor) -> torch.Tensor:
        """Local ``(L, s, ...)`` blocks → the global ``(S·s, ...)`` set."""
        return merge(self.gather_lanes(blocks))

    def psum(self, per_shard: torch.Tensor) -> torch.Tensor:
        """Sum over all S shards of a ``(L, ...)`` per-lane tensor."""
        local = torch.sum(per_shard, dim=0)
        if not self.distributed:
            return local
        import torch.distributed as dist

        buf = self._out(local)
        dist.all_reduce(buf)
        self.collectives += 1
        return self._back(buf, local)

    def roll(self, stack: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Global shard ``j``'s entry moves to shard ``j + shift`` (mod S),
        ``shift`` ±1: JAX's ring ``ppermute``.  Across processes each
        process sends the lane that leaves its run to the neighbour it
        enters and receives the one that enters its own."""
        if shift not in (1, -1):
            raise ValueError(f"the ring moves by ±1, got {shift}")
        out = torch.roll(stack, shift, dims=0)
        if not self.multiprocess:
            return out
        import torch.distributed as dist

        W, r = self.world_size, self.rank
        leave, enter = (-1, 0) if shift == 1 else (0, -1)
        dst, src = (r + shift) % W, (r - shift) % W
        send = self._out(stack[leave])
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                           dist.P2POp(dist.irecv, recv, src)]):
            req.wait()
        self.sends += 1
        self.collectives += 1
        out[enter] = self._back(recv, stack)
        return out

    def __repr__(self) -> str:
        return (f"ParticleMesh(num_shards={self.num_shards}, world_size={self.world_size}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend!r}, "
                f"distributed={self.distributed})")
