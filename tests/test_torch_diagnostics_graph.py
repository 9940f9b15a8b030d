"""The posterior-diagnostics pass as one program a key, on the CPU.

On the card ``PosteriorDiagnostics`` captures its pass once a key — the
shapes, the shard count, the config's ``max_points`` / ``row_chunk`` /
``bandwidth`` and the score closure — into a CUDA graph and replays it
(``telemetry/diagnostics.py:_capture``).  The card cannot run here, so these
tests put a stand-in graph behind that seam: it copies each compute's
tensors into the inputs it was built with and reruns the pass on those, as
a replay reads its static inputs.  They hold that the keyed pass reports
what the eager pass reports, that the key separates what it must (and
counts one capture a key in ``parallel/plan.py:capture_sentry``), that an
:class:`InputScore`'s data reach the pass as inputs — a changed drift
corpus changes the result as it does eagerly — and that a plain closure
stays eager.  The eager pass itself is held against JAX's in
``tests/test_torch_diagnostics.py``."""

import numpy as np
import pytest
import torch

from dist_svgd_torch.models.gmm import gmm_logp
from dist_svgd_torch.models.logreg import logreg_logp
from dist_svgd_torch.parallel.plan import capture_sentry, captures_total
from dist_svgd_torch.telemetry import diagnostics as tdiag
from dist_svgd_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
    InputScore,
    PosteriorDiagnostics,
    data_score,
)
from dist_svgd_torch.telemetry.metrics import MetricsRegistry
from dist_svgd_torch.tools.fault_drill import gmm_score_fn

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


class StandInGraph:
    """``parallel/plan.py:_Graph``'s interface on the CPU: static inputs
    cloned at capture, two warm-up calls and the captured call; a replay
    copies the arguments into the static inputs and reruns the pass on
    them."""

    made = []

    def __init__(self, fn, args):
        self.fn = fn
        self.static_in = [a.clone() for a in args]
        for _ in range(3):
            fn(*self.static_in)
        StandInGraph.made.append(self)

    def replay(self, args):
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        return self.fn(*self.static_in).clone()


@pytest.fixture
def graphs(monkeypatch):
    StandInGraph.made = []
    monkeypatch.setattr(tdiag, "_capture", lambda fn, args: StandInGraph(fn, args))
    return StandInGraph.made


def _gmm(n=256, d=2, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, d)) * 1.5,
                           dtype=torch.float32)


def _diag(score_fn, **cfg):
    cfg.setdefault("max_points", 128)
    cfg.setdefault("row_chunk", 64)
    return PosteriorDiagnostics(DiagnosticsConfig(score_fn=score_fn, **cfg),
                                registry=MetricsRegistry())


def _values(report):
    return {k: v for k, v in report.items() if k != "wall_s"}


@pytest.mark.parametrize("bandwidth", [1.0, "median"])
@pytest.mark.parametrize("shards", [1, 4])
def test_graphed_pass_reports_equal_the_eager_pass(monkeypatch, bandwidth, shards):
    """The GMM score (an InputScore), no score and passed scores, three
    computes each: the keyed pass's reports are the eager pass's, bitwise."""
    parts = _gmm()
    scores = torch.func.vmap(torch.func.grad(gmm_logp))(parts)
    cases = [(gmm_score_fn, None), (lambda: None, None), (lambda: None, scores)]

    def run(make_score, sc):
        diag = _diag(make_score(), bandwidth=bandwidth)
        return [_values(diag.compute(parts + step * 1e-3, scores=sc, num_shards=shards,
                                     step=step)) for step in (16, 32, 48)]

    eager = [run(*case) for case in cases]  # the CPU's pass: no graph
    StandInGraph.made = []
    monkeypatch.setattr(tdiag, "_capture", lambda fn, args: StandInGraph(fn, args))
    assert [run(*case) for case in cases] == eager
    assert len(StandInGraph.made) == 3


def test_pass_key_separates_shapes_shards_config_and_closure(graphs):
    parts = _gmm()
    score = gmm_score_fn()
    diag = _diag(score)
    c0 = captures_total()
    with capture_sentry("keys") as sentry:
        diag.compute(parts, num_shards=4)
        diag.compute(parts * 2, num_shards=4)        # same key: a replay
        assert captures_total() - c0 == len(graphs) == 1
        diag.compute(parts, num_shards=2)            # shards
        diag.compute(parts, num_shards=3)            # 256 % 3: no shard block
        diag.compute(parts, num_shards=1)            # ... which is the 1-shard key
        diag.compute(_gmm(n=192), num_shards=4)      # n
        diag.compute(parts.double(), num_shards=4)   # dtype
        diag.config.max_points = 64                  # the config
        diag.compute(parts, num_shards=4)
        diag.config.row_chunk = 32
        diag.compute(parts, num_shards=4)
        diag.config.bandwidth = "median"
        diag.compute(parts, num_shards=4)
        other = _diag(gmm_score_fn())                # another closure
        other.compute(parts, num_shards=4)
        eager = _diag(torch.func.grad(gmm_logp))     # a plain closure: eager
        eager.compute(parts, num_shards=4)
    assert sentry.captures == len(graphs) == 9
    assert len(diag._graphs) == 8 and len(other._graphs) == 1 and not eager._graphs


def _logreg_score(data):
    return torch.func.grad(lambda th: logreg_logp(th, data))


def _corpus(seed, rows=96, dim=4):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(rows, dim)), dtype=torch.float32)
    t = torch.as_tensor(rng.integers(0, 2, size=rows) * 2 - 1, dtype=torch.float32)
    return x, t


def test_changed_corpus_changes_the_graphed_result_as_eager(graphs):
    """A drift check's data ride the pass's inputs: swapping the corpus
    between computes changes the replayed report exactly as it changes the
    eager one, and never captures again."""
    parts = torch.as_tensor(0.3 * np.random.default_rng(4).normal(size=(64, 5)),
                            dtype=torch.float32)
    box = [_corpus(1)]
    graphed = _diag(data_score(lambda: box[0], _logreg_score), max_points=64, row_chunk=32)
    reports = []
    for seed in (1, 2, 1, 3):
        box[0] = _corpus(seed)
        got = graphed.compute(parts)
        want = _diag(_logreg_score(box[0]), max_points=64, row_chunk=32).compute(parts)
        assert _values(got) == _values(want)
        reports.append(got["ksd"])
    assert len(graphs) == 1
    assert reports[0] == reports[2] and len({reports[0], reports[1], reports[3]}) == 3


def test_input_score_calls_and_inputs():
    box = [_corpus(5)]
    score = data_score(lambda: box[0], _logreg_score)
    theta = torch.zeros(5)
    assert torch.equal(score(theta), _logreg_score(box[0])(theta))
    assert all(a is b for a, b in zip(score.inputs(), box[0]))
    assert InputScore(torch.func.grad(gmm_logp)).inputs() == ()


def test_streaming_drift_check_pins_through_the_keyed_pass(tmp_path, monkeypatch, graphs):
    """The streaming supervisor's drift check through the stand-in graph:
    one capture over the run, and each check's KSD the eager run's — the
    current corpus while the ring tiles, the pinned full ring after."""
    from test_torch_streaming import ROWS, ManualClock, _port, _stack

    ksds = {}
    for mode in ("graphed", "eager"):
        if mode == "eager":
            monkeypatch.setattr(tdiag, "_capture", lambda fn, args: None)  # eager
        pkg = _port()
        reg = pkg.tel.MetricsRegistry()
        clock = ManualClock(0.0)
        diag = pkg.tel.PosteriorDiagnostics(
            pkg.tel.DiagnosticsConfig(every_steps=1, row_chunk=32, max_points=32),
            registry=reg)
        _, _, sup = _stack(pkg, tmp_path / mode, clock, reg, diag=diag, corpus=4 * ROWS)
        sup.drift_guard = pkg.Guard(max_ksd=float("inf"))
        g = reg.gauge("svgd_diag_ksd")
        ksds[mode] = []
        for _ in range(7):
            clock.advance(1.0)
            sup.run_segment_once()
            ksds[mode].append(g.value() if g.has() else None)
    assert len(graphs) == 1
    assert ksds["graphed"] == ksds["eager"] and ksds["graphed"][-1] is not None
