"""The op recorder: the facts the program auditor reads, from one eager call.

Counterpart of ``dist_svgd_tpu/analysis/stablehlo.py``.  JAX re-lowers a
program and parses its StableHLO text; a port program is eager Python, so
the port runs **one call** of it under a recording
``torch.utils._python_dispatch.TorchDispatchMode`` (:class:`OpRecorder`).
For every aten op the call dispatches, the mode records its name, the
shapes and dtypes of its outputs, and the storages of its inputs and
outputs: which outputs are **new** buffers (a storage no input or earlier
op holds — a view, an in-place op or an ``out=`` write allocates nothing)
and, through weak references to those storages, when each buffer dies.

The hand kernels are called through ``ctypes`` (``ops/_build.py``), so the
mode does not see inside them; it does see every tensor their wrappers
allocate — outputs, partial sums, the pre-pass scratch.  That is the
boundary the audit wants: a kernel's Gram tiles live on chip, and any
buffer in device memory was allocated by an op the mode saw.

The mode calls each op as it was dispatched and returns its result, so a
call under it computes exactly what it computes outside it.  A collective
of the particle mesh (``parallel/mesh.py``) is counted through the mesh's
tap, by kind and per-shard payload: on one process the mesh's collectives
are lane reshapes and sums the mode cannot tell from any other op.

From the record (:class:`OpRecord`) come the counterparts of
``stablehlo.py``'s facts: :meth:`OpRecord.internal_dtypes`,
:meth:`OpRecord.nxn_buffer_count` (the same rule: a new buffer with at
least two axes equal to n, never for n < 2), :meth:`OpRecord.
largest_tensor_bytes` and :attr:`OpRecord.peak_live_bytes` — the most
bytes the call's own new buffers held at once, measured at op boundaries.
On the card the recorder also reads ``torch.cuda.max_memory_allocated``
over the call (:attr:`OpRecord.peak_allocated_bytes`: the peak above what
was allocated when the call began).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from dist_svgd_torch.parallel import mesh as _mesh

__all__ = ["DTYPE_NAMES", "OpRecord", "OpRecorder", "dtype_name", "flat_tensors",
           "record_call"]

#: torch dtypes under the StableHLO spellings JAX's cards use.
DTYPE_NAMES: Dict[torch.dtype, str] = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
    torch.int16: "i16", torch.int8: "i8", torch.bool: "i1", torch.uint8: "ui8",
    torch.complex64: "c64", torch.complex128: "c128",
}
for _name, _spelling in (("uint16", "ui16"), ("uint32", "ui32"), ("uint64", "ui64")):
    if hasattr(torch, _name):
        DTYPE_NAMES[getattr(torch, _name)] = _spelling


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def flat_tensors(value) -> List[torch.Tensor]:
    """Every tensor in a (nested) tuple / list / dict, in order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in flat_tensors(v)]
    return []


def _storage_key(t: torch.Tensor) -> Optional[Tuple[str, int]]:
    """The identity of ``t``'s buffer (``None`` for an empty one)."""
    s = t.untyped_storage()
    if s.nbytes() == 0:
        return None
    return (str(s.device), s.data_ptr())


class OpRecord:
    """One recorded call: ``ops`` is ``[(name, [(shape, dtype, nbytes,
    new), ...]), ...]`` in dispatch order; ``inputs`` the dtypes and shapes
    of the tensors the call read without producing them (its arguments and
    the tensors it closes over); ``collectives`` and
    ``collective_payload_bytes`` the mesh collectives by kind."""

    def __init__(self):
        self.ops: List[Tuple[str, List[Tuple[tuple, torch.dtype, int, bool]]]] = []
        self.inputs: List[Tuple[tuple, torch.dtype]] = []
        self.collectives: Dict[str, int] = {}
        self.collective_payload_bytes: Dict[str, int] = {}
        self.peak_live_bytes = 0
        self.peak_allocated_bytes: Optional[int] = None

    def op_names(self) -> List[str]:
        return [name for name, _ in self.ops]

    def outputs(self, new_only: bool = False) -> Iterable[Tuple[tuple, torch.dtype, int]]:
        for _, outs in self.ops:
            for shape, dtype, nbytes, new in outs:
                if new or not new_only:
                    yield shape, dtype, nbytes

    def internal_dtypes(self) -> Set[str]:
        """Dtypes of the tensors the call's ops produced."""
        return {dtype_name(dtype) for _, dtype, _ in self.outputs()}

    def input_dtypes(self) -> Set[str]:
        """Dtypes of the non-scalar tensors the call read without producing
        them (its arguments and closed-over constants)."""
        return {dtype_name(dtype) for shape, dtype in self.inputs if len(shape)}

    def nxn_buffer_count(self, n: Optional[int]) -> int:
        """Ops that materialised a new buffer with at least two axes equal
        to ``n`` — the n×n (Gram-shaped) detector.  ``n < 2`` never
        matches."""
        if n is None or n < 2:
            return 0
        count = 0
        for _, outs in self.ops:
            if any(new and sum(1 for d in shape if d == n) >= 2
                   for shape, _, _, new in outs):
                count += 1
        return count

    def largest_tensor_bytes(self) -> int:
        """The largest buffer the call materialised."""
        return max((nbytes for _, _, nbytes in self.outputs(new_only=True)), default=0)


class OpRecorder(TorchDispatchMode):
    """The recording dispatch mode (module docstring); use through
    :func:`record_call`."""

    def __init__(self):
        super().__init__()
        self.record = OpRecord()
        # buffers that predate the call (arguments, closed-over tensors) and
        # buffers its ops created, each with a weak reference to tell when it
        # dies: a freed address may be handed to a new buffer
        self._external: Dict[Tuple[str, int], StorageWeakRef] = {}
        self._live: Dict[Tuple[str, int], Tuple[StorageWeakRef, int]] = {}
        self._live_bytes = 0
        self._inputs_seen: Set[tuple] = set()

    def tap(self, kind: str, nbytes: int) -> None:
        rec = self.record
        rec.collectives[kind] = rec.collectives.get(kind, 0) + 1
        rec.collective_payload_bytes["shards"] = (
            rec.collective_payload_bytes.get("shards", 0) + nbytes)

    def _sweep(self) -> None:
        for k in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self._live_bytes -= self._live.pop(k)[1]
        for k in [k for k, ref in self._external.items() if ref.expired()]:
            del self._external[k]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._sweep()
        in_keys = set()
        for t in flat_tensors(args) + flat_tensors(kwargs):
            key = _storage_key(t)
            if key is None:
                continue
            in_keys.add(key)
            if key not in self._live and key not in self._external:
                self._external[key] = StorageWeakRef(t.untyped_storage())
            if key in self._external:
                seen = (key, tuple(t.shape), t.dtype)
                if seen not in self._inputs_seen:
                    self._inputs_seen.add(seen)
                    self.record.inputs.append((tuple(t.shape), t.dtype))
        outs = []
        for t in flat_tensors(out):
            key = _storage_key(t)
            new = (key is not None and key not in in_keys and key not in self._live
                   and key not in self._external)
            if new:
                size = t.untyped_storage().nbytes()
                self._live[key] = (StorageWeakRef(t.untyped_storage()), size)
                self._live_bytes += size
            outs.append((tuple(t.shape), t.dtype, t.numel() * t.element_size(), new))
        self.record.peak_live_bytes = max(self.record.peak_live_bytes, self._live_bytes)
        self.record.ops.append((str(func), outs))
        return out


def record_call(fn: Callable, args: tuple, kwargs: Optional[dict] = None
                ) -> Tuple[Any, OpRecord]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpRecorder`, with
    the mesh's collective tap installed; returns ``(result, record)``.  On
    the card ``record.peak_allocated_bytes`` is the allocator's peak above
    what was allocated when the call began."""
    kwargs = kwargs or {}
    devices = {t.device for t in flat_tensors(args) + flat_tensors(kwargs)}
    cuda = next((d for d in devices if d.type == "cuda"), None)
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
    recorder = OpRecorder()
    _mesh.add_tap(recorder.tap)
    try:
        with recorder, torch.no_grad():
            out = fn(*args, **kwargs)
    finally:
        _mesh.remove_tap(recorder.tap)
    if cuda is not None:
        torch.cuda.synchronize(cuda)
        recorder.record.peak_allocated_bytes = int(
            torch.cuda.max_memory_allocated(cuda) - base)
    return out, recorder.record
