"""Program cards and the XP rule family: the audit of tracked programs.

Counterpart of ``dist_svgd_tpu/analysis/audit.py``.  A **program card** is
the audit summary of one tracked program (one
:class:`~dist_svgd_torch.analysis.registry.ProgramEntry`): its collective
inventory, the donation verdict, the buffer inventory and the dtype story
of inputs against internals — JAX's fields under JAX's names and dtype
spellings (``f32``, ``bf16``, ``f64``, ``i32``, …), so the two packages'
cards compare field by field.  Where JAX re-lowers a program and reads its
jaxpr and StableHLO, the port runs one call of it, rebuilt from the first
call's signature (:meth:`ProgramEntry.call_args`), under the op recorder
(``analysis/oprecord.py``).  A card counts **one step**, as a jaxpr counts
a scan's body once: the port's scanned programs are the scan's body.

The port's meanings where they differ from JAX's:

- **collectives** are the particle mesh's (``parallel/mesh.py``) under
  JAX's primitive names (:data:`COLLECTIVE_PRIMS`: gather → ``all_gather``,
  sum over shards → ``psum``, ring hop → ``ppermute``), counted where the
  port issues them, on one process as across several;
  ``collective_payload_bytes`` is each call's per-shard input bytes under
  the mesh axis ``shards``;
- **donation**: JAX counts aliasing markers in the lowering; the port
  counts the outputs whose storage is a donated input's storage in the
  recorded call (``donation_markers``).  ``aliasable_leaves`` is JAX's
  greedy shape-and-dtype match and ``donation_ok = markers >= aliasable``;
- **buffers**: ``nxn_buffers``, ``largest_intermediate_bytes`` and
  ``peak_live_bytes_est`` count the buffers the call's ops materialised (a
  view allocates nothing); on the card ``peak_allocated_bytes`` adds the
  allocator's peak over the call.

Findings are :class:`Finding` rows under the **XP** rules, with the path
``plan://<label>`` — JAX's conditions and messages:

- **XP001 materialized-nxn** — a program that declared ``gram_free`` built
  a buffer with two axes equal to the particle count;
- **XP002 collective-in-unsharded-plan** — a one-shard program issued a
  collective;
- **XP003 donation-dropped** — a donated leaf had an output to alias but
  the call wrote fewer outputs into donated storage; or the call site
  expects donation (``expect_donation``) and none was declared;
- **XP004 f64-promotion** — f64 tensors inside a program with no f64 input;
- **XP005 bf16-pollution** — bf16 internals in a ``pinned_f32`` program
  with no bf16 input.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dist_svgd_torch.analysis.oprecord import dtype_name, flat_tensors, record_call
from dist_svgd_torch.analysis.registry import (
    KEY_AVAL,
    ProgramEntry,
    ProgramRegistry,
    iter_tensor_avals,
    scalar_dtype,
)
from dist_svgd_torch.parallel.mesh import COLLECTIVE_PRIMS

__all__ = [
    "COLLECTIVE_PRIMS",
    "Finding",
    "ProgramCard",
    "XP_RULES",
    "audit_entry",
    "audit_registry",
    "xp_findings",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit: ``path:line: RULE message`` (the jaxlint row's form)."""

    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


XP_RULES: Dict[str, str] = {
    "XP001": "materialized n×n buffer in a gram-free-declared program",
    "XP002": "cross-shard collective lowered in a single-shard plan",
    "XP003": "donation declared but aliasing dropped / stripped",
    "XP004": "silent f32→f64 promotion (f64 internals, no f64 input)",
    "XP005": "bf16 pollution of a pinned-f32 program",
}



@dataclasses.dataclass
class ProgramCard:
    """One tracked program's audit summary (module docstring)."""

    label: str
    kind: str                      # 'compile' | 'compile_sharded'
    num_shards: int
    input_signature: str           # "f64[24,3],f64[],i32[]" — the card key
    input_dtypes: List[str]        # args + closed-over tensors, sorted
    internal_dtypes: List[str]
    collectives: Dict[str, int]            # prim name -> count
    collective_payload_bytes: Dict[str, int]  # mesh axis -> bytes moved
    donated_leaves: int
    aliasable_leaves: int
    donation_markers: int
    donation_ok: bool
    n_particles: Optional[int]
    nxn_buffers: int
    largest_intermediate_bytes: int
    peak_live_bytes_est: int
    meta: Dict[str, Any]
    peak_allocated_bytes: Optional[int] = None  # the card's allocator peak; None off it

    @property
    def key(self) -> str:
        """Stable identity across runs: label + first-call signature."""
        return f"{self.label}({self.input_signature})"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d


# ------------------------------------------------------------------ #
# signatures


def _sig(shape, dtype) -> str:
    return f"{dtype_name(dtype)}[{','.join(str(int(d)) for d in shape)}]"


def _leaf_sigs(entry: ProgramEntry, argnums: Sequence[int]) -> List[Tuple[tuple, torch.dtype]]:
    """``(shape, dtype)`` of every traced leaf of the recorded arguments
    ``argnums`` (statics and ``None`` have none; a Python scalar is one
    0-d leaf, typed by :func:`~dist_svgd_torch.analysis.registry.
    scalar_dtype`; a ``key_argnums`` seed is JAX's key, :data:`~dist_svgd_torch.
    analysis.registry.KEY_AVAL`)."""
    out: List[Tuple[tuple, torch.dtype]] = []
    avals = entry.avals or ()
    for i in argnums:
        if i >= len(avals) or i in entry.static_argnums:
            continue
        rec = avals[i]
        if rec[0] == "static":
            continue
        if i in entry.key_argnums:
            out.append(KEY_AVAL)
        elif rec[0] == "scalar":
            out.append(((), scalar_dtype(rec[1], avals)))
        else:
            out.extend(iter_tensor_avals((rec,)))
    return out


def _greedy_alias_matches(donated: List[Tuple[tuple, torch.dtype]],
                          outputs: List[Tuple[tuple, torch.dtype]]) -> int:
    """How many donated leaves have a shape+dtype-matching output to alias
    (each output matches at most once)."""
    pool: Dict[Tuple, int] = {}
    for o in outputs:
        pool[o] = pool.get(o, 0) + 1
    hits = 0
    for d in donated:
        if pool.get(d, 0) > 0:
            pool[d] -= 1
            hits += 1
    return hits


def _donated_tensors(entry: ProgramEntry, args: tuple) -> List[torch.Tensor]:
    return [t for i in entry.donate_argnums if i < len(args) and i not in entry.static_argnums
            for t in flat_tensors(args[i])]


def _donation_markers(donated: List[torch.Tensor], outputs: List[torch.Tensor]) -> int:
    """Outputs written into a donated input's storage (each donated buffer
    counts once)."""
    pool = {}
    for t in donated:
        key = (str(t.device), t.untyped_storage().data_ptr())
        pool[key] = pool.get(key, 0) + 1
    hits = 0
    for t in outputs:
        key = (str(t.device), t.untyped_storage().data_ptr())
        if pool.get(key, 0) > 0:
            pool[key] -= 1
            hits += 1
    return hits


def audit_target(entry: ProgramEntry):
    """The eager callable the audit runs for ``entry`` (``None`` once the
    program died): a tracked callable's own function, a ``Plan`` program's
    eager body."""
    prog = entry.program()
    if prog is None:
        return None
    return getattr(prog, "audit_target", prog)


def run_entry(entry: ProgramEntry, *, record: bool = True, device=None):
    """One call of ``entry``'s program on :meth:`ProgramEntry.call_args`:
    ``(args, result, record)`` — the record ``None`` with ``record=False``
    (the same call outside the recorder)."""
    fn = audit_target(entry)
    if fn is None:
        raise ValueError(f"program {entry.label!r} died")
    args = entry.call_args(device)
    if record:
        out, rec = record_call(fn, args)
        return args, out, rec
    with torch.no_grad():
        return args, fn(*args), None


def audit_entry(entry: ProgramEntry, *, device=None,
                keep_output: bool = False) -> Optional[ProgramCard]:
    """Build the card of one registry entry; ``None`` when the program died
    or was never called.  The call runs on arguments rebuilt from the
    recorded signature, never on the program's live state.  With
    ``keep_output`` the card carries the call's result as ``card.output``
    (the recorder-changes-nothing check) and its op record as
    ``card.record``."""
    if not entry.alive or not entry.captured:
        return None
    args, out, rec = run_entry(entry, device=device)

    avals = entry.avals
    traced = [i for i in range(len(avals)) if i not in entry.static_argnums]
    in_leaves = _leaf_sigs(entry, traced)
    input_dtypes = sorted({dtype_name(dt) for _, dt in in_leaves} | rec.input_dtypes())
    donated_sigs = _leaf_sigs(entry, entry.donate_argnums)
    out_tensors = flat_tensors(out)
    aliasable = _greedy_alias_matches(
        donated_sigs, [(tuple(t.shape), t.dtype) for t in out_tensors])
    markers = _donation_markers(_donated_tensors(entry, args), out_tensors)

    p_arg = (entry.meta or {}).get("particles_arg", 0)
    n = None
    if p_arg is not None:  # None = no particle-shaped argument (W2 stacks)
        p_leaves = _leaf_sigs(entry, (int(p_arg),))
        if p_leaves and len(p_leaves[0][0]) >= 1:
            n = int(p_leaves[0][0][0])

    card = ProgramCard(
        label=entry.label,
        kind=entry.kind,
        num_shards=entry.num_shards,
        input_signature=",".join(_sig(s, dt) for s, dt in in_leaves),
        input_dtypes=input_dtypes,
        internal_dtypes=sorted(rec.internal_dtypes()),
        collectives=dict(sorted(rec.collectives.items())),
        collective_payload_bytes=dict(sorted(rec.collective_payload_bytes.items())),
        donated_leaves=len(donated_sigs),
        aliasable_leaves=aliasable,
        donation_markers=markers,
        donation_ok=(markers >= aliasable),
        n_particles=n,
        nxn_buffers=rec.nxn_buffer_count(n),
        largest_intermediate_bytes=rec.largest_tensor_bytes(),
        peak_live_bytes_est=rec.peak_live_bytes,
        meta=dict(entry.meta or {}),
        peak_allocated_bytes=rec.peak_allocated_bytes,
    )
    if keep_output:
        card.output = out  # type: ignore[attr-defined]
        card.record = rec  # type: ignore[attr-defined]
    return card


# ------------------------------------------------------------------ #
# the XP rules (pure on the card: red paths need no program)


def xp_findings(card: ProgramCard) -> List[Finding]:
    path = f"plan://{card.label}"
    meta = card.meta
    out: List[Finding] = []

    if meta.get("gram_free") and card.nxn_buffers > 0:
        out.append(Finding(path, 0, "XP001", (
            f"program declares gram_free but lowers {card.nxn_buffers} "
            f"{card.n_particles}x{card.n_particles} buffer(s) — the Gram "
            "matrix is materialized"
        )))

    if card.num_shards == 1 and card.collectives:
        inv = ", ".join(f"{k}x{v}" for k, v in card.collectives.items())
        out.append(Finding(path, 0, "XP002", (
            f"single-shard plan lowers cross-device collectives ({inv})"
        )))

    if card.donated_leaves and card.donation_markers < card.aliasable_leaves:
        out.append(Finding(path, 0, "XP003", (
            f"donation declared for {card.donated_leaves} leaf/leaves with "
            f"{card.aliasable_leaves} aliasable output match(es), but the "
            f"lowering carries only {card.donation_markers} aliasing/donor "
            "marker(s) — donation silently dropped"
        )))
    elif meta.get("expect_donation") and not card.donated_leaves:
        out.append(Finding(path, 0, "XP003", (
            "call site expects carry donation (expect_donation meta) but "
            "donate_argnums arrived empty — donation stripped"
        )))

    if (not meta.get("allow_f64") and "f64" in card.internal_dtypes
            and "f64" not in card.input_dtypes):
        out.append(Finding(path, 0, "XP004", (
            "f64 tensors materialize inside a program with no f64 input — "
            "weak-type promotion doubled the bandwidth"
        )))

    if (meta.get("pinned_f32") and "bf16" in card.internal_dtypes
            and "bf16" not in card.input_dtypes):
        out.append(Finding(path, 0, "XP005", (
            "bf16 internals in a pinned-f32 program with no bf16 input"
        )))
    return out


def audit_registry(registry: ProgramRegistry, *, label_prefix: str = "", device=None,
                   ) -> Tuple[List[ProgramCard], List[Finding]]:
    """Cards and findings for every live, called entry — deduplicated by
    card key (programs rebuilt for one label and signature audit once)."""
    cards: Dict[str, ProgramCard] = {}
    for entry in registry.entries(captured_only=True, label_prefix=label_prefix):
        card = audit_entry(entry, device=device)
        if card is not None and card.key not in cards:
            cards[card.key] = card
    ordered = [cards[k] for k in sorted(cards)]
    findings: List[Finding] = []
    for card in ordered:
        findings.extend(xp_findings(card))
    return ordered, findings
