"""The topology manifest of sampler checkpoints — the port's copy of the
manifest half of ``dist_svgd_tpu/utils/checkpoint.py`` (same keys, same
encoding), so a JAX ``DistSampler.state_dict()`` and the port's agree on
what a save describes.  The storage backends and ``reshard_state`` are not
ported yet (ROADMAP A4)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

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
                      data_rows_per_shard: int = 0) -> Dict[str, np.ndarray]:
    """The manifest entries of a single-process save: shard count, global
    particle count and dimension, per-shard particle counts (equal blocks —
    the drop-remainder policy runs at construction), the per-shard data
    partition (0 = no data), and the one-process layout."""
    s = int(n_shards)
    if s < 1:
        raise ValueError(f"n_shards must be >= 1, got {s}")
    return {
        "topo_n_shards": np.asarray(s, dtype=np.int64),
        "topo_n_particles": np.asarray(int(n_particles), dtype=np.int64),
        "topo_d": np.asarray(int(d), dtype=np.int64),
        "topo_particles_per_shard": np.full(s, int(n_particles) // s, dtype=np.int64),
        "topo_data_rows_per_shard": np.asarray(int(data_rows_per_shard), dtype=np.int64),
        "topo_process_count": np.asarray(1, dtype=np.int64),
        "topo_granule_shards": np.asarray([s], dtype=np.int64),
    }


def read_manifest(state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Parse the manifest out of a state dict: ``{'n_shards', 'n_particles',
    'd', 'particles_per_shard', 'data_rows_per_shard', 'process_count'}``, or
    ``None`` when the save has no manifest or an inconsistent one."""
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
    except (KeyError, TypeError, ValueError, OverflowError):
        return None
    if (man["n_shards"] < 1
            or man["particles_per_shard"].shape[0] != man["n_shards"]
            or int(man["particles_per_shard"].sum()) != man["n_particles"]):
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
            "requested (particle count and dimension cannot change)"
        )
    return man
