"""Program analysis of the port's tracked programs.

Counterpart of ``dist_svgd_tpu/analysis``.  ``registry`` records every
tracked program (the samplers' steps, the serving programs of
``Plan.compile``) with its first call's shapes and dtypes; ``audit`` runs
one call of each, rebuilt from that record, under ``oprecord``'s recording
dispatch mode and distils a **program card** (collective inventory,
donation verdict, n×n detector, dtype story) with findings under the
**XP001–XP005** rules.  ``dist_svgd_torch/tools/program_audit.py`` gates
the cards against a committed baseline; ``tests/test_torch_program_audit.py``
holds the cards against JAX's.
"""

from dist_svgd_torch.analysis.audit import (
    COLLECTIVE_PRIMS,
    ProgramCard,
    XP_RULES,
    audit_entry,
    audit_registry,
    xp_findings,
)
from dist_svgd_torch.analysis.registry import (
    ProgramEntry,
    ProgramRegistry,
    default_registry,
    use_registry,
)

__all__ = [
    "COLLECTIVE_PRIMS",
    "ProgramCard",
    "ProgramEntry",
    "ProgramRegistry",
    "XP_RULES",
    "audit_entry",
    "audit_registry",
    "default_registry",
    "use_registry",
    "xp_findings",
]
