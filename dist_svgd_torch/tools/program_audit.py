"""Program auditor gate: the tracked programs' cards against a committed
baseline, and the XP rules.

Counterpart of ``tools/program_audit.py``.  ``dist_svgd_torch/analysis``
audits every tracked program (one recorded eager call) into a **program
card** — collective inventory with per-shard payload bytes, the donation
verdict, the dtype sweep, the peak of live intermediates and the
materialised-n×n check.  This tool builds JAX's suite of representative
programs at JAX's shapes and seeds (:data:`BUILDERS`), audits them, and
compares each card against the baseline ``program_cards.json`` beside this
file, recorded by the port on the CPU.

A run FAILs when:

- any XP001–XP005 finding fires on a card (not allowlisted; the allowlist
  path suffix is ``plan://<label>``);
- a card's per-kind **collective count** exceeds its baseline;
- a baseline card had ``donation_ok`` and the current one does not, or its
  donation **marker count** dropped;
- a card's materialised-n×n buffer count grew;
- a card's ``num_shards`` changed;
- a card in the baseline was not produced, or a produced card has no
  baseline (``--record`` blesses a deliberate change).

``peak_live_bytes_est``, ``largest_intermediate_bytes`` and (on the card)
``peak_allocated_bytes`` ride on the card for the record but do not gate.
The declarations in ``meta`` do not gate either: the builders' ``'auto'``
φ declares nothing (as in JAX), so the CPU baseline holds on the card, where
``'auto'`` runs the hand kernels and the n×n counts fall to 0.

``--record`` refuses to overwrite the baseline while any card FAILs (a
finding or a regression; ``--force`` overrides); ``--list-missing`` reads the baseline file and
prints the builders that have no card in it, without building anything.
It is an audit baseline: nothing in it is timed.

Usage (the card unless ``--device cpu``)::

    python -m dist_svgd_torch.tools.program_audit --device cpu
    python -m dist_svgd_torch.tools.program_audit --device cpu --record
    python -m dist_svgd_torch.tools.program_audit --list-missing
    python -m dist_svgd_torch.tools.program_audit --builders sampler_exact --format json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

CARDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "program_cards.json")

#: Gate-relevant card fields: a baseline entry must carry all of these.
GATED_FIELDS = ("collectives", "donation_ok", "donation_markers", "nxn_buffers", "num_shards")

#: Report formats (``tools/jaxlint/report.py``'s three).
FORMATS = ("text", "json", "github")

#: Accepted findings: ``(path_suffix, rule, line_or_None, reason)``; a
#: finding is waived when its path ends with the suffix and its rule (and
#: line, when given) match.  Empty: every finding is fixed instead.
ALLOWLIST: List[Tuple[str, str, Optional[int], str]] = []


def is_allowlisted(path: str, rule: str, line: int, allowlist=None) -> bool:
    entries = ALLOWLIST if allowlist is None else allowlist
    norm = path.replace("\\", "/")
    for suffix, arule, aline, _reason in entries:
        if arule == rule and norm.endswith(suffix):
            if aline is None or aline == line:
                return True
    return False


def validate_allowlist(allowlist=None) -> List[str]:
    """Policy errors in the allowlist itself: an entry needs a reason."""
    entries = ALLOWLIST if allowlist is None else allowlist
    return [f"allowlist entry ({suffix!r}, {rule}) has no reason"
            for suffix, rule, _line, reason in entries if not reason.strip()]


def stale_entries(findings, allowlist=None) -> list:
    """Entries that waive nothing in ``findings``."""
    entries = ALLOWLIST if allowlist is None else allowlist
    return [entry for entry in entries
            if not any(f.rule == entry[1] and f.path.replace("\\", "/").endswith(entry[0])
                       and (entry[2] is None or entry[2] == f.line) for f in findings)]


# ---------------------------------------------------------------------------
# builder suite: JAX's shapes and seeds (n = 24 is no bucket size and no
# feature dim, so the n×n scan cannot collide with an unrelated axis)
# ---------------------------------------------------------------------------


def _quad_logp(theta, data=None):
    import torch

    return -0.5 * torch.sum(theta ** 2)


def _build_sampler_exact(device):
    from dist_svgd_torch.sampler import Sampler

    s = Sampler(2, _quad_logp, device=device)
    s.run(n=24, num_iter=3, step_size=0.1, seed=0)
    return s


def _build_sampler_rff(device):
    from dist_svgd_torch.sampler import Sampler

    s = Sampler(2, _quad_logp, kernel_approx="rff", phi_impl="torch", device=device)
    s.run(n=24, num_iter=3, step_size=0.1, seed=0)
    return s


def dist_particles():
    """The dist builders' f64 ``(16, 2)`` particles (JAX's, from numpy)."""
    import numpy as np

    return np.random.default_rng(0).normal(size=(16, 2))


def _build_dist_gather(device):
    from dist_svgd_torch.distsampler import DistSampler

    ds = DistSampler(2, _quad_logp, None, dist_particles(), include_wasserstein=False,
                     device=device)
    ds.run_steps(3, 0.05)
    return ds


def _build_dist_w2_sinkhorn(device):
    from dist_svgd_torch.distsampler import DistSampler

    ds = DistSampler(2, _quad_logp, None, dist_particles(), include_wasserstein=True,
                     wasserstein_solver="sinkhorn", device=device)
    ds.run_steps(3, 0.05)
    return ds


def _build_dist_rff(device):
    from dist_svgd_torch.distsampler import DistSampler

    ds = DistSampler(2, _quad_logp, None, dist_particles(), include_wasserstein=False,
                     kernel_approx="rff", phi_impl="torch", device=device)
    ds.run_steps(3, 0.05)
    return ds


def serve_particles():
    """The serving builders' f32 ``(64, 8)`` ensemble (JAX's, from numpy)."""
    import numpy as np

    return np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)


def _build_serve_logreg(device):
    import numpy as np

    from dist_svgd_torch.serving import PredictiveEngine

    eng = PredictiveEngine("logreg", serve_particles(), min_bucket=4, max_bucket=16,
                           device=device)
    eng.warmup()
    eng.predict(np.random.default_rng(2).normal(size=(3, 7)).astype(np.float32))
    return eng


def _build_serve_bf16(device):
    from dist_svgd_torch.serving import PredictiveEngine

    eng = PredictiveEngine("logreg", serve_particles(), min_bucket=4, max_bucket=8,
                           dtype="bfloat16", device=device)
    eng.warmup()
    return eng


#: name -> builder(device), in print order: the ``--list-missing`` contract.
BUILDERS = (
    ("sampler_exact", _build_sampler_exact),
    ("sampler_rff", _build_sampler_rff),
    ("dist_gather", _build_dist_gather),
    ("dist_w2_sinkhorn", _build_dist_w2_sinkhorn),
    ("dist_rff", _build_dist_rff),
    ("serve_logreg", _build_serve_logreg),
    ("serve_bf16", _build_serve_bf16),
)
BUILDER_NAMES = tuple(name for name, _ in BUILDERS)


def run_suite(names=None, device=None, keep_output: bool = False) -> Tuple[list, list]:
    """Build every requested suite entry in its own scoped registry on
    ``device`` (``None``: the card) and audit it.  Returns ``(cards,
    findings)``, each card's builder in ``card.meta['builder']``; with
    ``keep_output`` each card also carries its recorded call's result
    (``card.output``), its registry entry (``card.entry``) and the
    builder's object (``card.owner``, which keeps the program alive)."""
    from dist_svgd_torch.analysis import use_registry
    from dist_svgd_torch.analysis.audit import audit_entry, xp_findings

    selected = [(n, b) for n, b in BUILDERS if names is None or n in names]
    unknown = set(names or ()) - {n for n, _ in selected}
    if unknown:
        raise SystemExit(f"program_audit: unknown builder(s) {sorted(unknown)}; "
                         f"expected a subset of {list(BUILDER_NAMES)}")
    all_cards, all_findings = [], []
    for name, build in selected:
        with use_registry() as reg:
            # the registry holds weak references: keep the builder's object
            # (and so its programs) alive across the audit
            owner = build(device)
            cards: Dict[str, object] = {}
            for entry in reg.entries(captured_only=True):
                card = audit_entry(entry, keep_output=keep_output)
                if card is not None and card.key not in cards:
                    if keep_output:
                        card.entry = entry
                    cards[card.key] = card
        for key in sorted(cards):
            card = cards[key]
            card.meta["builder"] = name
            if keep_output:
                card.owner = owner
            all_cards.append(card)
            all_findings.extend(xp_findings(card))
        del owner
    return all_cards, all_findings


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------


def baseline_key(card) -> str:
    """Baseline identity: ``builder/label(signature)`` (``sampler_exact``
    and ``sampler_rff`` share a label and a signature)."""
    return f"{card.meta.get('builder', '?')}/{card.key}"


def load_baseline(path: str = CARDS_PATH) -> dict:
    if not os.path.exists(path):
        return {"cards": {}}
    with open(path) as fh:
        doc = json.load(fh)
    doc.setdefault("cards", {})
    return doc


def compare_card(cur: dict, base: dict) -> List[str]:
    """Regression reasons for one card against its baseline (empty = PASS)."""
    reasons = []
    for kind in sorted(set(cur["collectives"]) | set(base["collectives"])):
        was, now = base["collectives"].get(kind, 0), cur["collectives"].get(kind, 0)
        if now > was:
            reasons.append(f"collective {kind} count {was} -> {now}")
    if base["donation_ok"] and not cur["donation_ok"]:
        reasons.append("donation aliasing dropped (donation_ok True -> False)")
    if cur["donation_markers"] < base["donation_markers"]:
        reasons.append(f"donation markers {base['donation_markers']} -> "
                       f"{cur['donation_markers']}")
    if cur["nxn_buffers"] > base["nxn_buffers"]:
        reasons.append(f"materialized nxn buffers {base['nxn_buffers']} -> "
                       f"{cur['nxn_buffers']}")
    if cur["num_shards"] != base["num_shards"]:
        reasons.append(f"num_shards {base['num_shards']} -> {cur['num_shards']}")
    return reasons


def gate(cards, findings, baseline: dict,
         builders=BUILDER_NAMES) -> Tuple[List[dict], List, bool]:
    """Judge the suite: ``(rows, kept_findings, ok)``, each row ``{"card",
    "status", "reasons"}`` with status ``PASS`` / ``FAIL`` /
    ``NO_BASELINE`` / ``MISSING``; a kept (not allowlisted) finding FAILs
    every card of its label, naming the rule.  ``builders`` scopes the
    disappeared-card check to the builders that ran."""
    kept = [f for f in findings if not is_allowlisted(f.path, f.rule, f.line)]
    by_label: Dict[str, List] = {}
    for f in kept:
        by_label.setdefault(f.path[len("plan://"):], []).append(f)

    base_cards = baseline.get("cards", {})
    rows, seen = [], set()
    for card in cards:
        key = baseline_key(card)
        seen.add(key)
        reasons = [f"{f.rule}: {f.message}" for f in by_label.get(card.label, [])]
        base = base_cards.get(key)
        if base is None:
            status = "FAIL" if reasons else "NO_BASELINE"
            if not reasons:
                reasons = ["no baseline card — run --record to bless"]
        else:
            reasons += compare_card(card.as_dict(), base)
            status = "FAIL" if reasons else "PASS"
        rows.append({"card": key, "status": status, "reasons": reasons})
    in_scope = {key for key, card in base_cards.items() if card.get("builder") in builders}
    for key in sorted(in_scope - seen):
        rows.append({"card": key, "status": "MISSING",
                     "reasons": ["baseline card not produced by the suite"]})
    ok = all(r["status"] == "PASS" for r in rows)
    return rows, kept, ok


def missing_builders(baseline: dict, expected=BUILDER_NAMES) -> List[str]:
    """Builders with no card in the baseline file: their regression gates
    can never fire.  Reads the file only."""
    present = {card.get("builder") for card in baseline.get("cards", {}).values()}
    return [name for name in expected if name not in present]


def record(cards, path: str = CARDS_PATH, device: str = "cpu") -> None:
    doc = {
        "_meta": {
            "tool": "python -m dist_svgd_torch.tools.program_audit --device cpu --record",
            "environment": f"torch on {device}, one process",
            "gated_fields": list(GATED_FIELDS),
        },
        "cards": {},
    }
    for card in cards:
        d = card.as_dict()
        d["builder"] = card.meta.get("builder")
        doc["cards"][baseline_key(card)] = d
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def render_findings(findings, fmt: str, stream=None) -> None:
    """Findings as text lines (``path:line: RULE message``), one JSON
    document, or GitHub annotations (``::error file=…``)."""
    stream = stream if stream is not None else sys.stdout
    if fmt == "json":
        print(json.dumps({"findings": [f.as_dict() for f in findings]}), file=stream)
        return
    for f in findings:
        if fmt == "github":
            print(f"::error file={f.path},line={f.line},title={f.rule}::{f.message}",
                  file=stream)
        else:
            print(f.format(), file=stream)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dist_svgd_torch.tools.program_audit",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--builders", nargs="*", metavar="NAME",
                    help=f"suite subset to run (default: all of {' '.join(BUILDER_NAMES)})")
    ap.add_argument("--format", choices=FORMATS, default="text", dest="fmt",
                    help="finding/report format (default: text)")
    ap.add_argument("--record", action="store_true",
                    help="rewrite the baseline from this run (refused while a gate FAILs "
                         "— see --force)")
    ap.add_argument("--force", action="store_true",
                    help="allow --record despite a failing gate")
    ap.add_argument("--list-missing", action="store_true",
                    help="print the builders with no baseline card and exit (reads the "
                         "baseline only)")
    ap.add_argument("--cards-path", default=CARDS_PATH,
                    help="the baseline file (default: program_cards.json beside this tool)")
    ap.add_argument("--device", default=None,
                    help="where the suite runs (default: the card; 'cpu' here)")
    args = ap.parse_args(argv)

    baseline = load_baseline(args.cards_path)
    if args.list_missing:
        missing = missing_builders(baseline)
        print(json.dumps({"builders": len(BUILDER_NAMES), "missing": missing,
                          "gates": {name: "findings+regression" for name in missing}}))
        return 0

    cards, findings = run_suite(args.builders, device=args.device)
    rows, kept, ok = gate(cards, findings, baseline,
                          builders=tuple(args.builders) if args.builders else BUILDER_NAMES)
    summary = {"row": "program_audit", "status": "PASS" if ok else "FAIL",
               "cards": len(cards), "findings": len(kept)}
    if args.fmt == "json":
        print(json.dumps({"findings": [f.as_dict() for f in kept], "rows": rows,
                          "cards": [c.as_dict() for c in cards], "row": summary}))
    else:
        if args.fmt == "github" and kept:
            render_findings(kept, "github")
        for row in rows:
            line = f"program_audit: {row['status']:<11} {row['card']}"
            if row["reasons"]:
                line += "  [" + "; ".join(row["reasons"]) + "]"
            print(line)
        if args.fmt == "text" and kept:
            render_findings(kept, "text", stream=sys.stderr)
        print(json.dumps(summary))

    if args.record:
        if any(r["status"] == "FAIL" for r in rows) and not args.force:
            print("program_audit: refusing --record while a gate FAILs "
                  "(pass --force to bless deliberately)", file=sys.stderr)
            return 1
        record(cards, args.cards_path, device=str(args.device or "cuda"))
        print(json.dumps({"recorded_to": args.cards_path, "cards": len(cards)}))
        return 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
