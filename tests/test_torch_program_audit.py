"""The port's program auditor (``dist_svgd_torch/analysis``,
``dist_svgd_torch/tools/program_audit.py``) against JAX's.

Four layers, JAX's three (``tests/test_program_audit.py``) and the parity:

- **registry semantics** — ``analysis.registry`` records the first call's
  signature through ``Plan.compile`` and ``track``, scopes through
  ``use_registry``, holds programs by weakref (a dead program yields no
  card) and is bounded;
- **red paths** — a fixture that builds a Gram under a ``gram_free``
  declaration fires exactly one XP001, a stripped donation exactly one
  XP003, and each of XP002, XP004 and XP005 fires exactly once on its own
  fixture; fed to the gate, each flips its row to FAIL naming the rule;
- **the committed baseline** — ``dist_svgd_torch/tools/program_cards.json``
  covers every builder (``--list-missing`` empty), the suite judges PASS
  with zero findings against it, and a tampered baseline fails;
- **parity** — for each of the seven builders, run on JAX's inputs, the
  port's card equals JAX's committed card (``tools/program_cards.json``) on
  ``num_shards``, ``nxn_buffers``, the collectives and their payload,
  ``donation_ok``, the input signature and the declarations, and both
  packages report zero findings; ``sampler_exact`` also against a live run
  of JAX's suite; the recorder leaves every builder's outputs bitwise equal.

A fifth layer holds the port's donation to what it claims: a site declares
donation only where its step writes into the carry (the Jacobi
``dist.scan``, ``dist.w2_scan`` and ``sampler.scan``), every other site
declares none and still audits clean, a donated run never changes a tensor
handed out before it, and recorded histories are the same bits with and
without donation.

One deviation is held as a fact, not hidden: JAX's n×n scan reads only the
``@main`` body of the lowering, and the scanned φ of ``sampler_exact``
lowers into a private ``closed_call`` function, so JAX's card reads 0 n×n
buffers where its program does build the 24×24 Gram (``'auto'`` declares
nothing in either package, so no rule fires).  The port's recorder sees the
plain φ's (1, 24, 24) blocks; the test checks that JAX's lowering holds a
24×24 tensor outside ``@main``.
"""

import copy
import gc
import json
import os
import re

import numpy as np
import pytest
import torch

from dist_svgd_torch.analysis import (
    audit_entry,
    audit_registry,
    default_registry,
    use_registry,
)
from dist_svgd_torch.analysis.audit import run_entry
from dist_svgd_torch.analysis.registry import ProgramRegistry
from dist_svgd_torch.parallel.mesh import ParticleMesh
from dist_svgd_torch.parallel.plan import Plan
from dist_svgd_torch.tools import program_audit
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CARDS = os.path.join(REPO_ROOT, "tools", "program_cards.json")

#: Card fields the two packages share a meaning for.
PARITY_FIELDS = ("num_shards", "collectives", "collective_payload_bytes", "donation_ok",
                 "donated_leaves", "aliasable_leaves", "input_signature", "n_particles")


def _jax_cards() -> dict:
    with open(JAX_CARDS) as fh:
        return json.load(fh)["cards"]


def _port_baseline() -> dict:
    return program_audit.load_baseline()


@pytest.fixture(scope="module")
def suite():
    """The port's whole suite on the CPU, run once: cards with their
    recorded outputs and entries, and the findings."""
    return program_audit.run_suite(device="cpu", keep_output=True)


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------


def test_plan_compile_tracks_and_captures_first_call_avals():
    with use_registry() as reg:
        f = Plan(device="cpu").compile(lambda x: x * 2.0, label="t.double")
        (entry,) = reg.entries()
        assert entry.label == "t.double" and not entry.captured
        f(torch.zeros(5, 3))
        assert entry.captured and entry.avals == (((5, 3), torch.float32),)
        f(torch.ones(5, 3))  # steady state: no new entry, no re-capture
        assert len(reg.entries()) == 1 and entry.calls == 2
        (card,) = audit_registry(reg)[0]
        assert card.input_signature == "f32[5,3]" and card.kind == "compile"


def test_track_records_scalars_trees_and_statics():
    """A tracked eager callable records tensors as (shape, dtype), Python
    scalars by value (typed as JAX's call sites cast them), containers of
    tensors as trees and statics as themselves; call_args rebuilds a call
    on the recorded devices and never reuses the first call's tensors."""
    calls = []

    def fn(x, data, t, eps, mode):
        calls.append(mode)
        return x + eps * t + data["a"].sum()

    with use_registry() as reg:
        g = reg.track(fn, label="t.tracked", static_argnums=(4,), num_shards=2,
                      kind="compile_sharded")
        x = torch.ones(6, 3, dtype=torch.float64)
        g(x, {"a": torch.zeros(2, dtype=torch.int64)}, 3, 0.5, "m")
        (entry,) = reg.entries()
        assert entry.avals[0] == ((6, 3), torch.float64)
        assert entry.avals[1] == ("tree", {"a": ((2,), torch.int64)})
        assert entry.avals[2:] == (("scalar", 3), ("scalar", 0.5), ("static", "m"))
        args = entry.call_args()
        assert args[0] is not x and args[0].shape == x.shape and args[0].dtype == x.dtype
        assert args[2:] == (3, 0.5, "m") and torch.equal(args[1]["a"], torch.zeros(2).long())
        (card,) = audit_registry(reg)[0]
        assert card.input_signature == "f64[6,3],i64[2],i32[],f64[]"
        assert card.num_shards == 2 and card.kind == "compile_sharded"
        assert entry.describe()["static_argnums"] == [4] and entry.calls == 1
    assert calls == ["m", "m"]  # the audit called once more, outside the program's state


def test_use_registry_scopes_and_restores_the_default():
    outer = default_registry()
    with use_registry() as reg:
        assert default_registry() is reg
        f = Plan(device="cpu").compile(lambda x: x + 1, label="t.scoped")
        assert [e.label for e in reg.entries()] == ["t.scoped"]
        del f
    assert default_registry() is outer
    assert "t.scoped" not in [e.label for e in outer.entries()]


def test_dead_plan_yields_no_card():
    with use_registry() as reg:
        f = Plan(device="cpu").compile(lambda x: x - 1.0, label="t.dies")
        f(torch.zeros(4))
        (entry,) = reg.entries()
        assert entry.alive
        del f
        gc.collect()
        # a weakref only: the entry dies with the program, audits to no card
        # and drops out of the listings
        assert not entry.alive
        assert audit_entry(entry) is None
        cards, findings = audit_registry(reg)
        assert reg.entries() == []
    assert cards == [] and findings == []


def test_registry_capacity_is_bounded():
    with pytest.raises(ValueError, match="capacity"):
        ProgramRegistry(capacity=0)
    with use_registry(ProgramRegistry(capacity=3)) as reg:
        plan = Plan(device="cpu")
        fns = [plan.compile((lambda i: lambda x: x + i)(i), label=f"t.{i}") for i in range(5)]
        assert len(reg.entries()) == 3
        # FIFO eviction keeps the newest programs
        assert [e.label for e in reg.entries()] == [f"t.{i}" for i in (2, 3, 4)]
        del fns


# ---------------------------------------------------------------------------
# red paths
# ---------------------------------------------------------------------------


def _gram_fixture_cards():
    """A program that declares gram-free but builds an n×n Gram."""

    def gram_step(x):
        g = torch.exp(-torch.sum((x[:, None, :] - x[None, :, :]) ** 2, -1))
        return g @ x

    with use_registry() as reg:
        f = Plan(device="cpu").compile(gram_step, label="t.gram", audit=dict(gram_free=True))
        f(torch.zeros(24, 2))
        return audit_registry(reg)


def _stripped_donation_cards():
    """Donation expected by the call site but stripped from the compile."""
    with use_registry() as reg:
        f = Plan(device="cpu").compile(lambda x: x + 1.0, donate_argnums=(), label="t.nodon",
                                       audit=dict(expect_donation=True))
        f(torch.zeros(8, 2))
        return audit_registry(reg)


def _dropped_donation_cards():
    """A donated carry with a matching output the call never wrote into."""
    with use_registry() as reg:
        g = reg.track(lambda x: x + 1.0, label="t.dropped", donate_argnums=(0,),
                      meta=dict(expect_donation=True))
        g(torch.zeros(8, 2))
        return audit_registry(reg)


def _unsharded_collective_cards():
    """A one-shard program that issues the mesh's sum over shards."""
    mesh = ParticleMesh(2)
    with use_registry() as reg:
        g = reg.track(lambda x: mesh.psum(x.reshape(2, 4, 2)), label="t.coll")
        g(torch.zeros(8, 2))
        return audit_registry(reg)


def _f64_promotion_cards():
    """f64 internals in a program with no f64 input."""
    with use_registry() as reg:
        g = reg.track(lambda x: (x.double() * 2.0).float(), label="t.promote")
        g(torch.zeros(8, 2))
        return audit_registry(reg)


def _bf16_pollution_cards():
    """bf16 internals in a pinned-f32 program with no bf16 input."""
    with use_registry() as reg:
        f = Plan(device="cpu").compile(lambda x: x.bfloat16().float() * 2.0,
                                       label="t.pinned", audit=dict(pinned_f32=True))
        f(torch.zeros(8, 2))
        return audit_registry(reg)


def test_materialized_gram_fires_exactly_one_xp001():
    cards, findings = _gram_fixture_cards()
    (card,) = cards
    assert card.nxn_buffers > 0 and card.n_particles == 24
    assert [f.rule for f in findings] == ["XP001"]
    (f,) = findings
    assert f.path == "plan://t.gram"
    assert "24" in f.message  # names the offending dimension


def test_stripped_donation_fires_exactly_one_xp003():
    cards, findings = _stripped_donation_cards()
    (card,) = cards
    assert card.donated_leaves == 0
    assert [f.rule for f in findings] == ["XP003"]
    assert findings[0].path == "plan://t.nodon"


@pytest.mark.parametrize("fixture,rule,label", [
    (_dropped_donation_cards, "XP003", "t.dropped"),
    (_unsharded_collective_cards, "XP002", "t.coll"),
    (_f64_promotion_cards, "XP004", "t.promote"),
    (_bf16_pollution_cards, "XP005", "t.pinned"),
])
def test_each_remaining_rule_fires_exactly_once(fixture, rule, label):
    cards, findings = fixture()
    assert [(f.rule, f.path) for f in findings] == [(rule, f"plan://{label}")]
    (card,) = cards
    if rule == "XP003":
        assert (card.donated_leaves, card.aliasable_leaves, card.donation_markers) == (1, 1, 0)
    if rule == "XP002":
        assert card.collectives == {"psum": 1}
        assert card.collective_payload_bytes == {"shards": 32}  # one (4, 2) f32 lane


@pytest.mark.parametrize("fixture,rule", [
    (_gram_fixture_cards, "XP001"),
    (_stripped_donation_cards, "XP003"),
    (_dropped_donation_cards, "XP003"),
    (_unsharded_collective_cards, "XP002"),
    (_f64_promotion_cards, "XP004"),
    (_bf16_pollution_cards, "XP005"),
])
def test_gate_row_flips_fail_naming_the_rule(fixture, rule):
    cards, findings = fixture()
    baseline = {"cards": {program_audit.baseline_key(c): c.as_dict() for c in cards}}
    rows, kept, ok = program_audit.gate(cards, findings, baseline, builders=("?",))
    assert not ok
    (row,) = [r for r in rows if r["status"] == "FAIL"]
    assert any(rule in reason for reason in row["reasons"])


def test_healthy_plan_zero_findings():
    with use_registry() as reg:
        g = reg.track(lambda x: x.mul_(0.5), donate_argnums=(0,), label="t.ok",
                      meta=dict(gram_free=True, expect_donation=True))
        g(torch.zeros(24, 2))
        cards, findings = audit_registry(reg)
    (card,) = cards
    assert findings == []
    assert card.donation_ok and card.donation_markers == 1 and card.nxn_buffers == 0


# ---------------------------------------------------------------------------
# gate arithmetic (pure)
# ---------------------------------------------------------------------------


def _card_dict(**over):
    base = dict(collectives={"all_gather": 1}, donation_ok=True, donation_markers=1,
                nxn_buffers=0, num_shards=2)
    base.update(over)
    return base


def test_compare_card_flags_each_regression_axis():
    base = _card_dict()
    cmp = program_audit.compare_card
    assert cmp(_card_dict(), base) == []
    assert any("all_gather" in r for r in cmp(_card_dict(collectives={"all_gather": 2}), base))
    assert any("donation aliasing dropped" in r for r in cmp(_card_dict(donation_ok=False), base))
    assert any("markers" in r for r in cmp(_card_dict(donation_markers=0), base))
    assert any("nxn" in r for r in cmp(_card_dict(nxn_buffers=3), base))
    assert any("num_shards" in r for r in cmp(_card_dict(num_shards=1), base))
    # fewer collectives / more markers are improvements, not regressions
    assert cmp(_card_dict(collectives={}, donation_markers=2), base) == []


def test_gate_subset_run_does_not_flag_unbuilt_builders_missing():
    baseline = {"cards": {"a/lbl(x)": dict(_card_dict(), builder="a"),
                          "b/lbl(x)": dict(_card_dict(), builder="b")}}
    rows, kept, ok = program_audit.gate([], [], baseline, builders=("a",))
    assert [r["status"] for r in rows] == ["MISSING"] and rows[0]["card"] == "a/lbl(x)"
    assert not ok
    rows, _, _ = program_audit.gate([], [], baseline, builders=("a", "b"))
    assert sorted(r["card"] for r in rows) == ["a/lbl(x)", "b/lbl(x)"]


def test_allowlist_waives_by_path_suffix_and_rule():
    entries = [("plan://t.gram", "XP001", None, "a fixture")]
    assert program_audit.is_allowlisted("plan://t.gram", "XP001", 0, entries)
    assert not program_audit.is_allowlisted("plan://t.gram", "XP003", 0, entries)
    assert program_audit.validate_allowlist() == [] and program_audit.ALLOWLIST == []
    assert program_audit.validate_allowlist([("plan://x", "XP001", None, " ")])
    cards, findings = _gram_fixture_cards()
    assert program_audit.stale_entries(findings, entries) == []
    assert program_audit.stale_entries([], entries) == entries


# ---------------------------------------------------------------------------
# the committed baseline
# ---------------------------------------------------------------------------


def test_baseline_artifact_covers_every_builder():
    doc = _port_baseline()
    assert program_audit.missing_builders(doc) == []
    for key, card in doc["cards"].items():
        assert key.startswith(card["builder"] + "/")
        for field in program_audit.GATED_FIELDS:
            assert field in card, (key, field)


def test_list_missing_reads_the_file_only(tmp_path, capsys):
    empty = tmp_path / "cards.json"
    empty.write_text(json.dumps({"cards": {}}))
    rc = program_audit.main(["--list-missing", "--cards-path", str(empty)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["missing"] == list(program_audit.BUILDER_NAMES)
    assert set(doc["gates"]) == set(program_audit.BUILDER_NAMES)
    assert program_audit.main(["--list-missing"]) == 0
    assert json.loads(capsys.readouterr().out)["missing"] == []


def test_full_suite_zero_findings_and_gate_green(suite):
    cards, findings = suite
    assert findings == []
    rows, kept, ok = program_audit.gate(cards, findings, _port_baseline())
    assert ok, [r for r in rows if r["status"] != "PASS"]
    assert len(cards) == len(_port_baseline()["cards"])
    assert {c.meta["builder"] for c in cards} == set(program_audit.BUILDER_NAMES)


def test_cli_passes_and_a_tampered_baseline_fails(suite, tmp_path, monkeypatch, capsys):
    cards, findings = suite
    monkeypatch.setattr(program_audit, "run_suite", lambda names=None, device=None: suite)
    assert program_audit.main(["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["status"] == "PASS"
    doc = copy.deepcopy(_port_baseline())
    key = program_audit.baseline_key(cards[0])
    # pretend the incumbent had one more donation marker: the "current
    # build silently dropped aliasing" signature
    doc["cards"][key]["donation_markers"] += 1
    tampered = tmp_path / "cards.json"
    tampered.write_text(json.dumps(doc))
    assert program_audit.main(["--device", "cpu", "--cards-path", str(tampered)]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and "markers" in out
    # --record refuses while a gate FAILs, and --force overrides
    assert program_audit.main(["--device", "cpu", "--record", "--cards-path",
                               str(tampered)]) == 1
    assert json.loads(tampered.read_text()) == doc
    assert program_audit.main(["--device", "cpu", "--record", "--force", "--cards-path",
                               str(tampered)]) == 0
    assert json.loads(tampered.read_text())["cards"][key]["donation_markers"] == \
        _port_baseline()["cards"][key]["donation_markers"]
    capsys.readouterr()
    assert program_audit.main(["--device", "cpu", "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["row"]["findings"] == 0


# ---------------------------------------------------------------------------
# parity with JAX
# ---------------------------------------------------------------------------


def _meta(card: dict) -> dict:
    return {k: v for k, v in card["meta"].items() if k != "builder"}


#: Where the port's donation differs from JAX's by design (ROADMAP C): the
#: W2 scan step writes the particles and the snapshot into their carries,
#: while the dual is the solve's own new tensor — two donated leaves where
#: JAX donates three.
DONATION_DEVIATIONS = {"dist.w2_scan": {"donated_leaves": (2, 3), "aliasable_leaves": (2, 3)}}


@pytest.mark.parametrize("builder", program_audit.BUILDER_NAMES)
def test_builder_cards_equal_jax_committed_cards(suite, builder):
    cards, findings = suite
    mine = {c.key: c.as_dict() for c in cards if c.meta["builder"] == builder}
    theirs = {v["key"]: v for v in _jax_cards().values() if v["builder"] == builder}
    assert set(mine) == set(theirs) and mine
    for key, card in mine.items():
        ref = theirs[key]
        for field in PARITY_FIELDS:
            mine_want, jax_has = DONATION_DEVIATIONS.get(card["label"], {}).get(
                field, (ref[field], ref[field]))
            assert card[field] == mine_want and ref[field] == jax_has, (key, field)
        assert _meta(card) == _meta(ref), key
        if builder == "sampler_exact":
            # JAX's @main-only scan misses the Gram its closed_call builds
            # (module docstring); the port counts it
            assert ref["nxn_buffers"] == 0 and card["nxn_buffers"] > 0
        else:
            assert card["nxn_buffers"] == ref["nxn_buffers"], key
    assert [f for f in findings if f.path.startswith("plan://")
            and any(f.path == f"plan://{c['label']}" for c in mine.values())] == []


def test_jax_committed_cards_have_zero_findings():
    from dist_svgd_tpu.analysis.audit import ProgramCard as JCard
    from dist_svgd_tpu.analysis.audit import xp_findings as jfindings

    fields = set(JCard.__dataclass_fields__)
    for key, card in _jax_cards().items():
        assert jfindings(JCard(**{k: v for k, v in card.items() if k in fields})) == [], key


def test_sampler_exact_against_a_live_jax_run(suite):
    """JAX's suite run live for one builder: its card equals the port's on
    the parity fields, and its lowering holds the 24×24 Gram outside the
    ``@main`` body its n×n scan reads."""
    from dist_svgd_tpu.analysis import use_registry as juse
    from dist_svgd_tpu.analysis.stablehlo import iter_tensor_types, nxn_buffer_count
    from tools import program_audit as jtool

    jcards, jfound = jtool.run_suite(["sampler_exact"])
    assert jfound == []
    (jc,) = jcards
    (mine,) = [c for c in suite[0] if c.meta["builder"] == "sampler_exact"]
    for field in PARITY_FIELDS:
        assert getattr(mine, field) == getattr(jc, field), field
    assert _meta(mine.as_dict()) == _meta(jc.as_dict())

    with juse() as reg:
        keep = jtool._build_sampler_exact()
        (entry,) = reg.entries(captured_only=True)
        text = entry.ref().lower(*entry.call_args()).as_text()
        del keep
    assert nxn_buffer_count(text, 24) == 0
    assert re.search(r"func\.func private @closed_call", text)
    assert any(shape == (24, 24) for shape, _ in iter_tensor_types(text))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("builder", program_audit.BUILDER_NAMES)
def test_recorder_leaves_outputs_bitwise_equal(suite, builder):
    from dist_svgd_torch.analysis.oprecord import flat_tensors

    for card in [c for c in suite[0] if c.meta["builder"] == builder]:
        _, out, _ = run_entry(card.entry, record=False)
        got, want = flat_tensors(card.output), flat_tensors(out)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(_bytes(a), _bytes(b)), card.key


def test_audit_leaves_the_samplers_state_alone(suite):
    """The audit runs on rebuilt arguments: the builders' particles, step
    counters and duals are what their runs left."""
    from dist_svgd_torch.analysis.audit import audit_entry as audit
    from dist_svgd_torch.distsampler import DistSampler

    checked = 0
    for card in suite[0]:
        owner = card.owner
        if not isinstance(owner, DistSampler):
            continue
        checked += 1
        before = {k: np.array(v, copy=True) for k, v in owner.state_dict().items()
                  if v is not None}
        audit(card.entry)
        after = owner.state_dict()
        for k, v in before.items():
            assert np.array_equal(v, np.asarray(after[k])), (card.key, k)
    assert checked == 3


# ---------------------------------------------------------------------------
# donation: declared where the step writes in place, and nowhere else
# ---------------------------------------------------------------------------


def test_key_argnums_spell_the_seed_as_jax_key():
    """A seed argument named in ``key_argnums`` is called as the plain int
    and spelled on the card as JAX's threefry key."""
    seen = []

    def fn(x, seed):
        seen.append(seed)
        return x * 2.0

    with use_registry() as reg:
        g = reg.track(fn, label="t.keyed", key_argnums=(1,))
        g(torch.ones(3), 7)
        (entry,) = reg.entries()
        assert entry.avals[1] == ("scalar", 7) and entry.call_args()[1] == 7
        (card,) = audit_registry(reg)[0]
    assert card.input_signature == "f32[3],ui32[2]" and "ui32" in card.input_dtypes
    assert seen == [7, 7]


def _dist(**kw):
    from dist_svgd_torch.distsampler import DistSampler

    kw.setdefault("include_wasserstein", False)
    if kw["include_wasserstein"]:
        kw.setdefault("wasserstein_solver", "sinkhorn")
    return DistSampler(2, program_audit._quad_logp, None, program_audit.dist_particles(),
                       device="cpu", **kw)


def _sampler(**kw):
    from dist_svgd_torch.sampler import Sampler

    s = Sampler(2, program_audit._quad_logp, device="cpu", **kw)
    s.run(n=12, num_iter=2, step_size=0.1, seed=0)
    return s


def _driven(owner, drive):
    drive(owner)
    return owner


#: configuration -> (build and drive: the owner of the programs, {label:
#: donated leaves}).
DONATION_SITES = {
    "scan_jacobi": (lambda: _driven(_dist(), lambda ds: ds.run_steps(2, 0.05)),
                    {"dist.scan": 1}),
    "scan_gauss_seidel": (lambda: _driven(_dist(update_rule="gauss_seidel"),
                                          lambda ds: ds.run_steps(2, 0.05)),
                          {"dist.scan": 0}),
    "scan_lagged": (lambda: _driven(_dist(exchange_every=2, exchange_scores=False),
                                    lambda ds: ds.run_steps(2, 0.05)), {"dist.scan": 0}),
    "w2_scan_block": (lambda: _driven(_dist(include_wasserstein=True, w2_pairing="block"),
                                      lambda ds: ds.run_steps(2, 0.05)), {"dist.w2_scan": 2}),
    "w2_scan_global": (lambda: _driven(_dist(include_wasserstein=True),
                                       lambda ds: ds.run_steps(2, 0.05)), {"dist.w2_scan": 2}),
    "make_step_w2": (lambda: _driven(_dist(include_wasserstein=True),
                                     lambda ds: [ds.make_step(0.05) for _ in range(2)]),
                     {"dist.step": 0, "dist.sinkhorn": 0}),
    "w2_chunks": (lambda: _driven(_dist(include_wasserstein=True, sinkhorn_iters=100),
                                  lambda ds: ds.run_steps(2, 0.05, max_passes_per_dispatch=60)),
                  {"dist.step": 0, "dist.w2_chunk.advance": 0, "dist.w2_chunk.final": 0}),
    "sampler_jacobi": (_sampler, {"sampler.scan": 1}),
    "sampler_gauss_seidel": (lambda: _sampler(update_rule="gauss_seidel"),
                             {"sampler.scan": 0}),
}


@pytest.mark.parametrize("config", sorted(DONATION_SITES))
def test_donation_declared_only_where_the_step_writes_in_place(config):
    """Each site's cards: the donated leaves it declares (none where the
    step allocates its result), every declared leaf written in place
    (markers = donated = aliasable), ``expect_donation`` exactly where
    donation is declared, and no finding."""
    drive, want = DONATION_SITES[config]
    with use_registry() as reg:
        owner = drive()  # noqa: F841 (keeps the programs alive)
        cards, findings = audit_registry(reg)
    got = {}
    for c in cards:
        assert got.setdefault(c.label, c.donated_leaves) == c.donated_leaves, c.key
        assert c.donation_markers == c.aliasable_leaves == c.donated_leaves, c.key
        assert c.meta["expect_donation"] is (c.donated_leaves > 0), c.key
    assert got == want and findings == []


def _w2_sampler(pairing):
    return _dist(include_wasserstein=True, w2_pairing=pairing)


@pytest.mark.parametrize("pairing", ["block", "global"])
@pytest.mark.parametrize("first", ["make_step", "intra_step", "state_dict"])
def test_a_donated_run_changes_no_tensor_handed_out_before(pairing, first):
    """What ``make_step``, a chunked (non-donated) run or ``state_dict``
    handed out stays as it was through a donated ``run_steps`` — under
    block pairing the next snapshot is the returned particles' own
    storage."""
    ds = _w2_sampler(pairing)
    if first == "make_step":
        ds.make_step(0.05)
        handed = {"particles": ds.make_step(0.05)}
    elif first == "intra_step":
        handed = {"particles": ds.run_steps(2, 0.05, max_passes_per_dispatch=80)}
    else:
        ds.run_steps(2, 0.05)
        handed = {k: torch.from_numpy(v) for k, v in ds.state_dict().items()
                  if isinstance(v, np.ndarray) and v.dtype.kind == "f"}
        assert {"particles", "previous", "w2_g"} <= set(handed)
    want = {k: v.clone() for k, v in handed.items()}
    ds.run_steps(2, 0.05)
    for k, v in handed.items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("spill", [False, True])
@pytest.mark.parametrize("kind", ["sampler", "dist", "dist_w2"])
def test_recorded_history_is_the_same_with_and_without_donation(kind, spill, monkeypatch):
    """A recorded run copies each snapshot before the step that may write
    over it: the history and the final particles are the same bits with
    ``donate_carries`` on and off, on the device or spilled to the host a
    chunk at a time."""
    from dist_svgd_torch.utils import history

    if spill:
        monkeypatch.setattr(history, "RECORD_CHUNK_MAX", 2)
    outs = []
    for donate in (True, False):
        if kind == "sampler":
            from dist_svgd_torch.sampler import Sampler

            s = Sampler(2, program_audit._quad_logp, device="cpu", donate_carries=donate)
            final, hist = s.run(n=12, num_iter=5, step_size=0.1, seed=0)
        else:
            ds = _dist(include_wasserstein=kind == "dist_w2", donate_carries=donate)
            final, hist = ds.run_steps(5, 0.05, record=True)
        assert isinstance(hist, np.ndarray) is spill
        outs.append((final, torch.as_tensor(np.asarray(hist))))
    (f1, h1), (f0, h0) = outs
    assert h1.shape[0] == (6 if kind == "sampler" else 5)
    assert torch.equal(f1, f0) and torch.equal(h1, h0)
    assert not torch.equal(h1[0], h1[-1])


# ---------------------------------------------------------------------------
# collectives across processes
# ---------------------------------------------------------------------------

#: One rank of a W = 2 gloo federation on the CPU: ``python -c AUDIT_WORKER
#: rank W host:port outdir``.  It runs the dist_gather builder's sampler on
#: a two-process mesh for one step, audits its ``dist.scan`` and writes the
#: card and the c10d ops the recording mode saw to ``rank<r>.json``.
AUDIT_WORKER = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from dist_svgd_torch import DistSampler
from dist_svgd_torch.analysis import use_registry
from dist_svgd_torch.analysis.audit import audit_entry, xp_findings
from dist_svgd_torch.parallel import multihost
from dist_svgd_torch.tools.program_audit import _quad_logp, dist_particles
rank, W, coord, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
assert multihost.initialize(coord, W, rank, backend="gloo", timeout_s=60, device="cpu")
try:
    mesh = multihost.make_particle_mesh(2, device="cpu")
    start, count = multihost.process_local_rows(16, mesh)
    parts = multihost.make_global_particles(dist_particles()[start:start + count], mesh,
                                            n_global=16)
    with use_registry() as reg:
        ds = DistSampler(2, _quad_logp, None, parts, mesh=mesh, include_wasserstein=False,
                         device="cpu")
        ds.run_steps(1, 0.05)
        (entry,) = reg.entries(captured_only=True, label_prefix="dist.scan")
        card = audit_entry(entry, keep_output=True)
    c10d = sorted({n for n in card.record.op_names() if n.startswith("c10d")})
    with open(f"{out}/rank{rank}.json", "w") as fh:
        json.dump({"card": card.as_dict(), "c10d": c10d,
                   "findings": [f.rule for f in xp_findings(card)]}, fh)
finally:
    multihost.shutdown()
"""


@pytest.fixture(scope="module")
def two_rank_audit(tmp_path_factory):
    import subprocess
    import sys

    from dist_svgd_torch.utils.ports import listen_port

    out = tmp_path_factory.mktemp("audit_fed")
    coord = f"127.0.0.1:{listen_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO_ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", AUDIT_WORKER, str(r), "2", coord,
                               str(out)], cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_two_process_dist_scan_card_counts_jax_collectives(two_rank_audit):
    """Across two gloo processes each rank's ``dist.scan`` card reads JAX's
    one gather and one psum a step with JAX's per-shard payload; the
    recording mode also sees the c10d ops under gloo, which the card does
    not count (the mesh's counters do)."""
    jax_card = _jax_cards()["dist_gather/dist.scan(f64[16,2],i32[],ui32[2],f64[],f64[])"]
    for rep in two_rank_audit:
        card = rep["card"]
        assert card["collectives"] == jax_card["collectives"] == {"all_gather": 1, "psum": 1}
        assert card["collective_payload_bytes"] == jax_card["collective_payload_bytes"]
        assert card["num_shards"] == 2 and card["donation_ok"] and rep["findings"] == []
        # a process's rows: the signature's particles are its own 8 of 16
        assert card["input_signature"] == "f64[8,2],i32[],ui32[2],f64[],f64[]"
        assert rep["c10d"] == ["c10d.allgather_.default", "c10d.allreduce_.default"]
