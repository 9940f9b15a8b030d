"""Checkpoint / resume for long SVGD runs.

Counterpart of ``dist_svgd_tpu/utils/checkpoint.py``, with the same keys,
encodings, directory layout and file name, so a save of either package
loads in the other (``utils/interop.py`` carries a JAX state's tensors
across):

- :func:`save_state` / :func:`load_state` persist a flat dict of arrays as
  ``<path>/state.npz`` — the JAX package's npz layout.  The card has no
  orbax, so this is the only backend: a directory in orbax's layout raises
  ``ImportError`` (as JAX's loader does without orbax), a directory holding
  neither layout ``ValueError``.  A save writes ``<path>.tmp`` and renames
  it, so a crash mid-write never leaves a truncated checkpoint.
- :class:`CheckpointManager` keeps the every-K-steps cadence, retention of
  the newest ``max_to_keep`` ``step_<t>`` directories, latest-step
  discovery and a :meth:`~CheckpointManager.restore_latest` that falls back
  past an unloadable newest step.
- The topology manifest (:func:`topology_manifest`) stamped into every
  sampler ``state_dict``, checked before any tensor op
  (:func:`check_topology`, :class:`TopologyMismatch`), and the reshard of a
  save to another shard count: :func:`reshard_previous_stack` for the W2
  snapshot stack, :func:`reshard_state` for a whole state, and
  :func:`assemble_full_state` for the per-process blocks of one save.

JAX's ``split_state_for_processes`` (per-process blocks of a full state,
the multi-process emulation seam) waits for the ``torch.distributed``
backend (ROADMAP A10) and is not here.
"""

from __future__ import annotations

import os
import re
import shutil
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

#: A step directory of :class:`CheckpointManager` (JAX's pattern).
_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
#: The npz layout's file name inside a checkpoint directory (JAX's).
_NPZ_NAME = "state.npz"
#: Files whose presence marks an orbax-layout checkpoint (JAX's markers).
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt")

#: Keys of the topology manifest stamped into every sampler checkpoint.
MANIFEST_KEYS = (
    "topo_n_shards",
    "topo_n_particles",
    "topo_d",
    "topo_particles_per_shard",
    "topo_data_rows_per_shard",
    "topo_process_count",
    "topo_granule_shards",
)


class TopologyMismatch(ValueError):
    """A checkpoint's saved topology manifest does not match the sampler it
    is being loaded into.  Raised before any tensor is touched, with both
    sides in one line."""


def topology_manifest(n_shards: int, n_particles: int, d: int,
                      data_rows_per_shard: int = 0, process_count: int = 1,
                      granule_shards=None) -> Dict[str, np.ndarray]:
    """The manifest entries of a save: shard count, global particle count
    and dimension, per-shard particle counts (equal blocks — the
    drop-remainder policy runs at construction), the per-shard data
    partition (0 = no data), and the process layout (``granule_shards``
    defaults to an equal split over ``process_count``)."""
    s = int(n_shards)
    if s < 1:
        raise ValueError(f"n_shards must be >= 1, got {s}")
    w = int(process_count)
    if w < 1:
        raise ValueError(f"process_count must be >= 1, got {w}")
    if granule_shards is None:
        if s % w:
            raise ValueError(f"process_count {w} does not divide n_shards {s}: pass "
                             "the explicit granule_shards layout")
        granule_shards = (s // w,) * w
    g = np.asarray(granule_shards, dtype=np.int64).reshape(-1)
    if g.shape[0] != w or int(g.sum()) != s or int(g.min()) < 1:
        raise ValueError(f"granule_shards {tuple(int(x) for x in g)} does not lay out "
                         f"{s} shards over {w} processes")
    return {
        "topo_n_shards": np.asarray(s, dtype=np.int64),
        "topo_n_particles": np.asarray(int(n_particles), dtype=np.int64),
        "topo_d": np.asarray(int(d), dtype=np.int64),
        "topo_particles_per_shard": np.full(s, int(n_particles) // s, dtype=np.int64),
        "topo_data_rows_per_shard": np.asarray(int(data_rows_per_shard), dtype=np.int64),
        "topo_process_count": np.asarray(w, dtype=np.int64),
        "topo_granule_shards": g,
    }


def read_manifest(state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Parse the manifest out of a state dict: ``{'n_shards', 'n_particles',
    'd', 'particles_per_shard', 'data_rows_per_shard', 'process_count',
    'granule_shards'}``, or ``None`` when the save has no manifest or an
    inconsistent one."""
    if state.get("topo_n_shards") is None:
        return None
    try:
        man = {
            "n_shards": int(np.asarray(state["topo_n_shards"])),
            "n_particles": int(np.asarray(state["topo_n_particles"])),
            "d": int(np.asarray(state["topo_d"])),
            "particles_per_shard": np.asarray(
                state["topo_particles_per_shard"], dtype=np.int64).reshape(-1),
            "data_rows_per_shard": int(np.asarray(state.get("topo_data_rows_per_shard", 0))),
            "process_count": int(np.asarray(state.get("topo_process_count", 1))),
        }
        gs = state.get("topo_granule_shards")
        man["granule_shards"] = (np.full(1, man["n_shards"], dtype=np.int64) if gs is None
                                 else np.asarray(gs, dtype=np.int64).reshape(-1))
    except (KeyError, TypeError, ValueError, OverflowError):
        return None
    if (man["n_shards"] < 1
            or man["particles_per_shard"].shape[0] != man["n_shards"]
            or int(man["particles_per_shard"].sum()) != man["n_particles"]):
        return None
    if (man["process_count"] < 1
            or man["granule_shards"].shape[0] != man["process_count"]
            or int(man["granule_shards"].sum()) != man["n_shards"]):
        return None
    return man


def check_topology(state: Dict[str, Any], expect: Dict[str, int],
                   context: str = "checkpoint") -> Optional[Dict[str, Any]]:
    """Compare a state's manifest against ``expect`` (any subset of
    ``n_shards`` / ``n_particles`` / ``d``); raise :class:`TopologyMismatch`
    naming both sides on a mismatch.  Manifest-less saves pass; returns the
    parsed manifest (or ``None``)."""
    man = read_manifest(state)
    if man is None:
        return None
    bad = {k: v for k, v in expect.items() if v is not None and man.get(k) != int(v)}
    if bad:
        saved = ", ".join(f"{k}={man[k]}" for k in sorted(bad))
        want = ", ".join(f"{k}={int(v)}" for k, v in sorted(bad.items()))
        raise TopologyMismatch(
            f"{context} was saved at topology ({saved}) but ({want}) was "
            "requested — reshard the state with "
            "dist_svgd_torch.utils.checkpoint.reshard_state(state, n_shards) "
            "(shard counts convert exactly; particle count / dimension cannot "
            "change)"
        )
    return man


def reshard_previous_stack(prev_arr: np.ndarray, n: int, d: int, want: tuple) -> np.ndarray:
    """A W2 ``previous`` snapshot stack saved under one shard layout, in the
    layout ``want`` — exactly, from the shard-independent pre- and
    post-update global states the stacks encode:

    - the post-update global is each shard's own block, concatenated (a
      mixed stack carries it inside the snapshots; a block stack is it);
    - a mixed stack at ``S_old ≥ 2`` also carries every pre-update row
      (block ``b``'s sits in any other shard's snapshot), so a mixed stack
      at any new S is rebuilt verbatim.

    A target that needs pre-update rows the save does not hold (a block or
    single-shard save → a mixed stack at S > 1) raises ``ValueError``."""
    prev_arr = np.asarray(prev_arr)
    if prev_arr.shape == tuple(want):
        return prev_arr
    if prev_arr.ndim != 3 or prev_arr.shape[2] != d:
        raise ValueError(f"checkpoint 'previous' snapshot {prev_arr.shape} is not a "
                         f"snapshot stack for {n} particles of dim {d}")
    S_old, rows = prev_arr.shape[0], prev_arr.shape[1]
    exch_save = rows == n          # mixed per-shard snapshots
    part_save = rows * S_old == n  # owned-block stacks (S_old == 1: both)
    if not (exch_save or part_save):
        raise ValueError(
            f"checkpoint 'previous' snapshot {prev_arr.shape} matches neither a mixed "
            f"(S, {n}, {d}) nor an owned-block (S, {n}//S, {d}) stack for {n} particles")
    if exch_save:
        s_old = n // S_old
        post = np.concatenate([prev_arr[b, b * s_old:(b + 1) * s_old] for b in range(S_old)])
    else:
        post = prev_arr.reshape(n, d)
    S_new = want[0]
    if want[1] != n:  # block-sized target: the post-update blocks
        return post.reshape(want)
    if S_new == 1:
        return post.reshape(1, n, d)
    if not exch_save or S_old < 2:
        raise ValueError(
            f"cannot reshard 'previous' {prev_arr.shape} to {tuple(want)}: the save "
            "holds only post-update blocks (partitions-mode, w2_pairing='block', or "
            "single-shard save), but a global-pairing exchanged stack at "
            f"num_shards={S_new} needs the pre-update rows it never recorded")
    s_old = n // S_old
    pre = np.empty_like(post)
    for b in range(S_old):  # block b's pre-update rows: any other shard's snapshot
        pre[b * s_old:(b + 1) * s_old] = prev_arr[(b + 1) % S_old, b * s_old:(b + 1) * s_old]
    out = np.broadcast_to(pre, (S_new, n, d)).copy()
    s_new = n // S_new
    for r in range(S_new):
        out[r, r * s_new:(r + 1) * s_new] = post[r * s_new:(r + 1) * s_new]
    return out


def reshard_state(state: Dict[str, Any], n_shards_to: int) -> Dict[str, Any]:
    """A full-global state saved at N shards, loadable at ``n_shards_to``
    (JAX's ``reshard_state``):

    - the particles are unchanged (the global array is in logical block
      order, which no shard layout permutes);
    - the W2 ``previous`` stack is rebuilt for the new count in the family
      the save used (:func:`reshard_previous_stack`); a stack whose target
      depends on the loader's mode passes through for
      ``load_state_dict``'s reshard-on-restore;
    - the Sinkhorn duals ``w2_g`` are dropped when the count changes (their
      pairing is per block), so the first resumed solve starts cold;
    - the minibatch stream's root (JAX's ``rng_batch_key``, the port's
      ``rng_batch_seed``) is kept: each step's draw is keyed by
      ``(root, t)`` alone;
    - the kernel approximation's identity (``approx_method``,
      ``approx_dial``, ``approx_active``, ``approx_rff_redraw``, the bank's
      ``approx_bank_seed`` / JAX's ``approx_bank_key``,
      ``approx_landmark_idx``) passes through verbatim: the bank derives
      from its seed alone and the landmarks from the layout-free global
      particle order, so a resharded resume rebuilds the same
      approximation;
    - the manifest is restamped, with ``topo_resharded_from``.

    A target that does not divide the particle count lands at 1 shard, with
    JAX's warning.  A per-process block raises ``ValueError`` (assemble
    first, :func:`assemble_full_state`)."""
    M = int(n_shards_to)
    if M < 1:
        raise ValueError(f"n_shards_to must be >= 1, got {M}")
    parts = state.get("particles")
    if parts is None:
        raise ValueError("reshard_state needs a 'particles' entry — is this a "
                         "sampler checkpoint?")
    if int(np.asarray(state.get("particles_start", 0))) != 0:
        raise ValueError(
            "reshard_state needs the FULL global state, but this dict is a "
            "per-process block (particles_start != 0) — assemble every process's "
            "save with assemble_full_state first")
    parts = np.asarray(parts)
    n = parts.shape[0]
    d = parts.shape[1] if parts.ndim > 1 else 1
    man = read_manifest(state)
    if man is None:
        warnings.warn(
            "checkpoint carries no readable topology manifest (pre-elastic save, "
            f"or corrupt entries): inferring n={n}, d={d} from the particle array "
            "and resharding anyway", stacklevel=2)
        S_old = None
    else:
        if man["n_particles"] != n:
            raise TopologyMismatch(
                f"manifest says {man['n_particles']} particles but the 'particles' "
                f"array holds {n} rows — corrupt or mixed-up checkpoint")
        S_old = man["n_shards"]
    if n % M:  # JAX's text for the replicate-instead-of-shard fallback
        warnings.warn(f"ensemble of {n} particles is not divisible by {M} shards; "
                      "replicating instead of sharding (serving stays correct, the mesh "
                      "win is lost)", UserWarning, stacklevel=2)
        M = 1
    out = dict(state)
    prev = out.get("previous")
    if prev is not None:
        prev_arr = np.asarray(prev)
        if prev_arr.ndim == 3 and prev_arr.shape[2] == d:
            mixed = prev_arr.shape[1] == n and prev_arr.shape[0] >= 2
            want = (M, n, d) if (mixed and M > 1) else ((1, n, d) if M == 1
                                                        else (M, n // M, d))
            try:
                out["previous"] = reshard_previous_stack(prev_arr, n, d, want)
            except ValueError:
                pass  # the loader knows the mode-dependent target
    if S_old != M:  # the duals' per-block pairing does not survive a change
        out.pop("w2_g", None)
        out.pop("w2_g_start", None)
    rows_ps = man["data_rows_per_shard"] if man is not None else 0
    out.update(topology_manifest(M, n, d, rows_ps * (S_old or 1) // M))
    if S_old is not None:
        out["topo_resharded_from"] = np.asarray(S_old, dtype=np.int64)
    return out


def _to_numpy_tree(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``tree`` without its ``None`` values, every value as numpy (a tensor
    through the host)."""
    out = {}
    for k, v in tree.items():
        if v is None:
            continue
        if hasattr(v, "detach"):  # a torch tensor, on any device
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def save_state(path: str, state: Dict[str, Any], backend: str = "npz") -> str:
    """Persist a flat dict of arrays, tensors and scalars (``None`` values
    are elided) as ``<path>/state.npz``; returns the absolute path.

    ``backend`` is ``'npz'``, or JAX's ``'auto'``, which is the npz layout
    here (the card has no orbax).  The directory is written as ``<path>.tmp``
    and renamed over any existing checkpoint at ``path``."""
    if backend not in ("auto", "npz"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    arrays = _to_numpy_tree(state)
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _NPZ_NAME), **arrays)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _looks_like_orbax(entries) -> bool:
    return any(m in entries for m in _ORBAX_MARKERS) or any(
        e.startswith("ocdbt.process_") for e in entries)


def load_state(path: str, expect_topology: Optional[Dict[str, int]] = None
               ) -> Dict[str, Any]:
    """Load a checkpoint written by :func:`save_state` (or by the JAX
    package's npz backend) as a dict of numpy arrays.

    An orbax-layout directory raises ``ImportError`` (the port has no
    orbax; JAX raises the same without it), a directory holding neither
    layout ``ValueError`` — which :meth:`CheckpointManager.restore_latest`
    treats as corruption.  ``expect_topology`` (any subset of ``n_shards`` /
    ``n_particles`` / ``d``) is checked against the manifest as soon as the
    dict is read (:class:`TopologyMismatch`)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    npz = os.path.join(path, _NPZ_NAME)
    if os.path.exists(npz):
        with np.load(npz) as data:
            state = {k: data[k] for k in data.files}
    else:
        entries = os.listdir(path)
        if not _looks_like_orbax(entries):
            raise ValueError(
                f"checkpoint directory {path} holds neither layout (entries: "
                f"{sorted(entries)[:5]}) — partial write from a killed save?")
        raise ImportError(
            f"checkpoint directory {path} is in orbax's layout, which the port "
            "does not read (no orbax on the card); re-save it with the npz backend "
            "(dist_svgd_tpu.utils.checkpoint.save_state(..., backend='npz'))")
    if expect_topology:
        check_topology(state, expect_topology, context=f"checkpoint {path}")
    return state


def assemble_full_state(paths, expect_topology: Optional[Dict[str, int]] = None
                        ) -> Dict[str, Any]:
    """Assemble the per-process block checkpoints of one multi-process save
    (each holds its contiguous axis-0 rows of every block key, with a
    ``<key>_start`` offset) into the full-global state, stamped as one
    process (JAX's ``assemble_full_state``).  Replicated entries must agree
    bitwise across the files and blocks must be contiguous from row 0, else
    ``ValueError``; ``expect_topology`` is checked on every file first."""
    states = [load_state(p) for p in paths]
    if not states:
        raise ValueError("assemble_full_state needs at least one checkpoint")
    if expect_topology:
        for p, s in zip(paths, states):
            check_topology(s, expect_topology, context=f"checkpoint {p}")
    out: Dict[str, Any] = {}
    keys = {k for s in states for k in s if not k.endswith("_start")}
    for key in keys:
        holders = [s for s in states if s.get(key) is not None]
        if not holders:
            out[key] = None
            continue
        if not any(key + "_start" in s for s in holders):
            if len(holders) != len(states):
                raise ValueError(
                    f"checkpoint files disagree on the presence of {key!r} "
                    f"({len(holders)} of {len(states)} files carry it) — are these "
                    "paths from one complete multi-host save?")
            for s in holders[1:]:
                if not np.array_equal(np.asarray(s[key]), np.asarray(holders[0][key])):
                    raise ValueError(
                        f"checkpoint files disagree on {key!r} "
                        f"({np.asarray(holders[0][key])} vs {np.asarray(s[key])}) — "
                        "are these paths from one complete multi-host save?")
            out[key] = holders[0][key]
            continue
        parts = sorted(((int(np.asarray(s.get(key + "_start", 0))), s[key])
                        for s in holders), key=lambda p: p[0])
        cursor = 0
        for start, rows in parts:
            if start != cursor:
                raise ValueError(
                    f"checkpoint blocks for {key!r} are not contiguous: expected a "
                    f"block starting at row {cursor}, got {start} — are these paths "
                    "from one complete multi-host save?")
            cursor += rows.shape[0]
        out[key] = np.concatenate([rows for _, rows in parts])
    man = read_manifest(out)
    if man is not None:
        out["topo_process_count"] = np.asarray(1, dtype=np.int64)
        out["topo_granule_shards"] = np.full(1, man["n_shards"], dtype=np.int64)
    return out


class CheckpointManager:
    """Every-K-steps checkpointing with retention (JAX's
    ``CheckpointManager``): ``<root>/step_<t>/`` a checkpoint, the newest
    ``max_to_keep`` kept.  ``backend`` forwards to :func:`save_state`."""

    def __init__(self, root: str, every: int = 100, max_to_keep: int = 3,
                 backend: str = "auto"):
        if every <= 0:
            raise ValueError("every must be positive")
        if backend not in ("auto", "npz"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.root = os.path.abspath(root)
        self.every = every
        self.max_to_keep = max_to_keep
        self.backend = backend
        os.makedirs(self.root, exist_ok=True)

    def _step_dirs(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            m = _STEP_DIR_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = save_state(os.path.join(self.root, f"step_{step}"), state,
                          backend=self.backend)
        for old in self._step_dirs()[: -self.max_to_keep or None]:
            if old != step:
                shutil.rmtree(os.path.join(self.root, f"step_{old}"), ignore_errors=True)
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._step_dirs()
        return steps[-1] if steps else None

    def restore_latest(self, with_step: bool = False):
        """The newest loadable checkpoint's state, skipping (with a warning)
        any newer one that fails to load; ``with_step=True`` returns
        ``(step, state)``.  ``None`` (or ``(None, None)``) when nothing is
        restorable.  An ``ImportError`` (an orbax-layout save) propagates:
        it is the environment, not corruption."""
        for step in reversed(self._step_dirs()):
            path = os.path.join(self.root, f"step_{step}")
            try:
                state = load_state(path)
                return (step, state) if with_step else state
            except ImportError:
                raise
            except Exception as e:  # corrupt or partial: try the next-oldest
                warnings.warn(f"skipping unloadable checkpoint {path}: "
                              f"{type(e).__name__}: {e}")
        return (None, None) if with_step else None

    def clear(self) -> None:
        """Delete every checkpoint under the root (a new run must not let
        retention keep an older run's higher steps)."""
        for step in self._step_dirs():
            shutil.rmtree(os.path.join(self.root, f"step_{step}"), ignore_errors=True)
