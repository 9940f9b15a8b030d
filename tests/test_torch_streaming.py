"""The port's streaming package (``dist_svgd_torch/streaming/``) against
JAX's (``dist_svgd_tpu/streaming/``, ``tests/test_streaming.py``), on the
CPU.

The sources, the buffer and the ring are numpy in both packages and must
be bitwise equal: every source's ``batch_at`` and event times over seeds
and ``DriftAt`` windows of both kinds, scripted ``StreamBuffer``
poll / take / seek / overflow sequences (cursor, dropped count, watermark,
metric values), ``RowRing`` extends below, at and over capacity
(``data()`` and ``state_dict``), and the refusals' messages.

``StreamingSupervisor`` is then held against JAX's on one manual clock in
float64, each package over its own sampler, engine and reloader, with the
same initial particles and JAX's minibatch indices injected through the
port sampler's ``_batch_index_seam``: the segment records equal (batches,
rows, t, steps, watermark, drift, refit, reload_step, freshness_s, …) and
the particles at ``RTOL`` / ``ATOL``; a ``DriftAt`` label flip escalates
at the same segments in both; a mid-stream kill and cold resume is bitwise
the uninterrupted run; a rejected reload rolls back; a reloader with a
rollout gets one ``step()`` a segment and the decisions JAX's gets; metric
and span names letter for letter; the refusals message for message."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_svgd_tpu as jdt
from dist_svgd_tpu import streaming as jstream
from dist_svgd_tpu import telemetry as jtel
from dist_svgd_tpu.telemetry import trace as jtrace
from dist_svgd_tpu.models.logreg import make_logreg_split as jsplit
from dist_svgd_tpu.resilience import DriftAt as JDriftAt
from dist_svgd_tpu.resilience import GuardConfig as JGuardConfig
from dist_svgd_tpu.utils.rng import minibatch_key

import dist_svgd_torch as tdt
from dist_svgd_torch import streaming as tstream
from dist_svgd_torch import telemetry as ttel
from dist_svgd_torch.models.logreg import make_logreg_split as tsplit
from dist_svgd_torch.resilience import DriftAt, GuardConfig
from dist_svgd_torch.telemetry import trace as ttrace

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: JAX ('xla') against the port ('torch') in float64, a few segments of
#: small steps: summation order only (tests/test_torch_resilience.py's).
RTOL, ATOL = 1e-10, 1e-12
#: The pre-train check KSD of both packages: the same float64 statistic on
#: particles that agree at RTOL.
KSD_RTOL = 1e-8


class ManualClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt_s):
        self.t += dt_s


def no_sleep(_s):
    pass


def _port():
    from dist_svgd_torch.rollout import RolloutController, RolloutPlan
    from dist_svgd_torch.serving import CheckpointHotReloader, PredictiveEngine
    from dist_svgd_torch.telemetry.diagnostics import ReloadPolicy

    def sampler(d, lik, data, batch_size, log_prior, seed):
        s = tdt.Sampler(d, lik, kernel=tdt.RBF(1.0), data=data, batch_size=batch_size,
                        log_prior=log_prior, phi_impl="torch", device="cpu")
        s._batch_index_seam = _jax_indices(seed, data[0].shape[0], batch_size)
        return s

    return SimpleNamespace(
        name="port", stream=tstream, tel=ttel, split=tsplit, DriftAt=DriftAt,
        Guard=GuardConfig, sampler=sampler,
        Engine=lambda *a, **kw: PredictiveEngine(*a, device="cpu", **kw),
        Reloader=CheckpointHotReloader, ReloadPolicy=ReloadPolicy,
        Controller=RolloutController, Plan=RolloutPlan, trace=ttrace,
        host=lambda p: p.detach().cpu().numpy())


def _jax():
    from dist_svgd_tpu.rollout import RolloutController, RolloutPlan
    from dist_svgd_tpu.serving import CheckpointHotReloader, PredictiveEngine
    from dist_svgd_tpu.telemetry.diagnostics import ReloadPolicy

    def sampler(d, lik, data, batch_size, log_prior, seed):
        return jdt.Sampler(d, lik, kernel=jdt.RBF(1.0), data=data, batch_size=batch_size,
                           log_prior=log_prior, phi_impl="xla")

    return SimpleNamespace(
        name="jax", stream=jstream, tel=jtel, split=jsplit, DriftAt=JDriftAt,
        Guard=JGuardConfig, sampler=sampler, Engine=PredictiveEngine,
        Reloader=CheckpointHotReloader, ReloadPolicy=ReloadPolicy,
        Controller=RolloutController, Plan=RolloutPlan, trace=jtrace, host=np.asarray)


PKGS = {"port": _port, "jax": _jax}


def _jax_indices(seed, n_rows, batch):
    """JAX's single-device minibatch stream: ``choice(fold_in(minibatch_key
    (seed), t), n, (B,), replace=False)``, t absolute."""
    root = minibatch_key(seed)
    return lambda t: np.array(jax.random.choice(jax.random.fold_in(root, t), n_rows,
                                                (batch,), replace=False))


# --------------------------------------------------------------------- #
# sources: bitwise JAX's


SOURCES = ("mean_shift", "label_flip", "growing", "covertype")
DRIFTS = {
    "none": (),
    "mean_shift window": (("mean_shift", 1.5, 2, 4),),
    "label_flip forever": (("label_flip", 0.5, 1, None),),
    "both": (("mean_shift", -2.0, 0, 3), ("label_flip", 1.0, 2, 5)),
}


def _source(mod, drift_cls, kind, seed, drift):
    faults = tuple(drift_cls(step, kind=k, magnitude=m, until=u) for k, m, step, u in drift)
    common = dict(seed=seed, period_s=2.5, start_time=10.0, faults=faults)
    if kind == "covertype":
        return mod.CovertypeReplayStream(n_rows=300, batch_rows=32, **common)
    common.update(batch_rows=24, dim=4)
    if kind == "mean_shift":
        return mod.MeanShiftStream(rate=0.25, **common)
    if kind == "label_flip":
        return mod.LabelFlipStream(rate=0.1, max_frac=0.4, **common)
    return mod.GrowingCorpusStream(**common)


@pytest.mark.parametrize("drift", list(DRIFTS))
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", SOURCES)
def test_source_batches_bitwise_jax(kind, seed, drift):
    """Every source's batches, event times and due() replay JAX's bytes,
    drift windows included."""
    j = _source(jstream, JDriftAt, kind, seed, DRIFTS[drift])
    p = _source(tstream, DriftAt, kind, seed, DRIFTS[drift])
    assert (p.batch_rows, p.dim, p.num_batches) == (j.batch_rows, j.dim, j.num_batches)
    for o in range(7):
        jb, pb = j.batch_at(o), p.batch_at(o)
        assert pb.ordinal == jb.ordinal and pb.event_time == jb.event_time
        assert pb.rows == jb.rows
        for a, b in ((pb.x, jb.x), (pb.y, jb.y)):
            assert a.dtype == b.dtype and a.flags.c_contiguous
            assert np.array_equal(a, b)
        for now in (jb.event_time - 1e-9, jb.event_time, jb.event_time + 0.5):
            assert p.due(o, now) == j.due(o, now)


def test_source_drift_set_after_construction_matches_jax():
    """The drivers arm drift by assigning ``faults`` mid-run: ordinals not
    yet drawn take it, in both packages."""
    j = _source(jstream, JDriftAt, "growing", 3, ())
    p = _source(tstream, DriftAt, "growing", 3, ())
    j.faults = (JDriftAt(2, kind="label_flip", magnitude=1.0),)
    p.faults = (DriftAt(2, kind="label_flip", magnitude=1.0),)
    for o in range(4):
        assert np.array_equal(p.batch_at(o).y, j.batch_at(o).y)


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", [
    lambda m, D: m.GrowingCorpusStream(batch_rows=0, dim=2),
    lambda m, D: m.GrowingCorpusStream(batch_rows=4, dim=0),
    lambda m, D: m.GrowingCorpusStream(batch_rows=4, dim=2, period_s=0.0),
    lambda m, D: m.GrowingCorpusStream(batch_rows=4, dim=2, faults=(object(),)),
    lambda m, D: m.LabelFlipStream(batch_rows=4, dim=2, max_frac=1.5),
    lambda m, D: m.GrowingCorpusStream(batch_rows=4, dim=2).batch_at(-1),
    lambda m, D: m.CovertypeReplayStream(n_rows=100, batch_rows=32).batch_at(3),
    lambda m, D: m.StreamBuffer(m.GrowingCorpusStream(batch_rows=4, dim=2), 0),
    lambda m, D: m.RowRing(0, 2),
])
def test_source_and_buffer_refusals_match_jax(case):
    """Bad geometry, a non-DriftAt fault, a negative ordinal, an ordinal past
    a bounded source, a zero-capacity buffer or ring: JAX's exception type
    and message."""
    assert _message(lambda: case(tstream, DriftAt)) == _message(lambda: case(jstream, JDriftAt))


# --------------------------------------------------------------------- #
# StreamBuffer: scripted sequences


BUFFER_SCRIPTS = {
    # (capacity, ops): ("poll", now) | ("take",) | ("seek", ordinal)
    "steady": (4, [("poll", 1.0), ("take",), ("poll", 2.5), ("poll", 3.0), ("take",),
                   ("poll", 3.0), ("take",)]),
    "overflow drops oldest": (2, [("poll", 5.0), ("take",), ("poll", 5.0), ("poll", 9.0),
                                  ("take",)]),
    "seek forward never back": (3, [("seek", 4), ("poll", 8.0), ("take",), ("seek", 2),
                                    ("poll", 10.0), ("take",), ("seek", 20), ("poll", 30.0),
                                    ("take",)]),
    "inclusive due": (8, [("poll", 0.999999), ("poll", 1.0), ("poll", 1.5), ("take",),
                          ("poll", 2.0), ("take",)]),
}


def _buffer_state(buf, reg):
    def metric(kind, name):
        m = getattr(reg, kind)(name)
        return m.value() if (kind == "counter" or m.has()) else None

    return {"next": buf.next_ordinal, "pulled": buf.pulled, "dropped": buf.dropped,
            "watermark": buf.watermark, "len": len(buf),
            "batches_total": metric("counter", "svgd_stream_batches_total"),
            "dropped_total": metric("counter", "svgd_stream_dropped_total"),
            "watermark_gauge": metric("gauge", "svgd_stream_watermark"),
            "depth": metric("gauge", "svgd_stream_buffer_depth")}


@pytest.mark.parametrize("script", list(BUFFER_SCRIPTS))
def test_buffer_sequences_match_jax(script):
    """poll / take / seek / overflow: every return value, the cursor, the
    dropped count, the watermark and the four metrics equal JAX's after
    each operation; taken batches are bitwise JAX's."""
    capacity, ops = BUFFER_SCRIPTS[script]
    sides = {}
    for name, mod in (("jax", jstream), ("port", tstream)):
        tel = jtel if name == "jax" else ttel
        reg = tel.MetricsRegistry()
        src = mod.GrowingCorpusStream(batch_rows=4, dim=2, seed=1, period_s=1.0,
                                      start_time=1.0)
        clock = ManualClock(0.0)
        buf = mod.StreamBuffer(src, capacity, registry=reg, clock=clock)
        trace = []
        for op in ops:
            if op[0] == "poll":
                clock.t = op[1]
                trace.append(("poll", buf.poll()))
            elif op[0] == "take":
                trace.append(("take", [(b.ordinal, b.event_time, b.x.tobytes(),
                                        b.y.tobytes()) for b in buf.take()]))
            else:
                trace.append(("seek", buf.seek(op[1])))
            trace.append(_buffer_state(buf, reg))
        sides[name] = trace
    assert sides["port"] == sides["jax"]


def test_buffer_poll_takes_explicit_now_like_jax():
    """``poll(now)`` with an explicit time ignores the clock in both."""
    out = {}
    for name, mod in (("jax", jstream), ("port", tstream)):
        tel = jtel if name == "jax" else ttel
        src = mod.GrowingCorpusStream(batch_rows=4, dim=2, seed=2)
        buf = mod.StreamBuffer(src, 8, registry=tel.MetricsRegistry(), clock=lambda: 0.0)
        out[name] = (buf.poll(3.0), buf.next_ordinal, buf.watermark)
    assert out["port"] == out["jax"] == (4, 4, 3.0)


# --------------------------------------------------------------------- #
# RowRing


RING_SCRIPTS = {
    "below capacity": (16, [3, 5]),
    "to capacity": (12, [5, 7]),
    "past capacity": (10, [4, 4, 4, 9]),
    "oversized extend": (6, [2, 15, 1]),
    "exact multiples": (8, [8, 8, 16]),
}


@pytest.mark.parametrize("script", list(RING_SCRIPTS))
def test_row_ring_sequences_bitwise_jax(script):
    """``extend`` sequences below, at and over capacity: ``data()``,
    ``state_dict()`` and ``written`` bitwise JAX's after every extend."""
    capacity, sizes = RING_SCRIPTS[script]
    rng = np.random.default_rng(len(script))
    rings = {"jax": jstream.RowRing(capacity, 3), "port": tstream.RowRing(capacity, 3)}
    for n in sizes:
        x = rng.normal(size=(n, 3)).astype(np.float32)
        y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
        for ring in rings.values():
            ring.extend(x, y)
        (jx, jy), (px, py) = rings["jax"].data(), rings["port"].data()
        for a, b in ((px, jx), (py, jy)):
            assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
            assert a.flags.c_contiguous
        assert rings["port"].written == rings["jax"].written
        js, ps = rings["jax"].state_dict(), rings["port"].state_dict()
        assert sorted(ps) == sorted(js)
        for k in js:
            assert ps[k].dtype == js[k].dtype and np.array_equal(ps[k], js[k]), k


def test_row_ring_state_crosses_packages():
    """A ring state either package writes loads into the other's ring with
    the same data."""
    rng = np.random.default_rng(9)
    src = {"jax": jstream.RowRing(7, 2), "port": tstream.RowRing(7, 2)}
    for ring in src.values():
        ring.extend(rng.normal(size=(9, 2)).astype(np.float32), np.ones(9))
    for a, b in (("jax", "port"), ("port", "jax")):
        dst = (jstream if b == "jax" else tstream).RowRing(7, 2)
        dst.load_state_dict(src[a].state_dict())
        for u, v in zip(dst.data(), src[a].data()):
            assert np.array_equal(u, v)
        assert dst.written == src[a].written


@pytest.mark.parametrize("case", [
    lambda m: m.RowRing(4, 3).data(),
    lambda m: m.RowRing(4, 3).extend(np.zeros((2, 2), np.float32), np.ones(2)),
    lambda m: m.RowRing(4, 3).extend(np.zeros((2, 3), np.float32), np.ones(3)),
    lambda m: m.RowRing(4, 3).extend(np.zeros(3, np.float32), np.ones(1)),
    lambda m: m.RowRing(6, 3).load_state_dict(m.RowRing(5, 3).state_dict()),
])
def test_row_ring_refusals_match_jax(case):
    """Data before any write, a wrong width, mismatched labels, a 1-D x, a
    checkpoint of another shape: JAX's exception and message."""
    assert _message(lambda: case(tstream)) == _message(lambda: case(jstream))


# --------------------------------------------------------------------- #
# StreamingSupervisor against JAX's


DIM, ROWS, CORPUS, BATCH, N = 3, 16, 32, 8, 16
STEP = 0.01


def _init(n=N, seed=4):
    return 0.3 * np.random.default_rng(seed).normal(size=(n, DIM + 1))


def _stack(pkg, root, clock, registry, *, seed=0, faults=(), reloader=None, diag=None,
           steps=2, refit_steps=6, init=None, buffer_capacity=8, step_size=STEP,
           corpus=CORPUS):
    source = pkg.stream.GrowingCorpusStream(batch_rows=ROWS, dim=DIM, seed=seed,
                                            period_s=1.0, start_time=1.0, faults=faults)
    buffer = pkg.stream.StreamBuffer(source, buffer_capacity, registry=registry, clock=clock)
    ring = pkg.stream.RowRing(corpus, DIM)
    lik, prior = pkg.split()
    sampler = pkg.sampler(DIM + 1, lik, (np.zeros((corpus, DIM), np.float32),
                                         np.ones((corpus,), np.float64)),
                          BATCH, prior, seed)
    sup = pkg.stream.StreamingSupervisor(
        sampler, step_size, buffer=buffer, ring=ring, steps_per_segment=steps,
        refit_steps=refit_steps, drift_diagnostics=diag, reloader=reloader,
        checkpoint_dir=str(root), checkpoint_every=steps, segment_steps=steps, n=N,
        seed=seed, registry=registry, clock=clock, sleep=no_sleep,
        initial_particles=_init() if init is None else init)
    return source, buffer, sup


def _engine(pkg, registry, **kw):
    return pkg.Engine("logreg", _init(seed=11), min_bucket=4, max_bucket=8,
                      registry=registry, **kw)


SEG_KEYS = ("segment", "t", "steps", "batches", "rows", "drift", "refit", "watermark",
            "dropped_total", "reload_step", "reload_rejected", "rollout", "freshness_s",
            "resumed_from", "train_status")


def _records(segs):
    return [{k: s[k] for k in SEG_KEYS} for s in segs]


def _drive(pkg, root, *, segments=4, advance=1.0, reload=True, **kw):
    reg = pkg.tel.MetricsRegistry()
    clock = ManualClock(0.0)
    engine = _engine(pkg, reg) if reload else None
    reloader = pkg.Reloader(engine, str(root)) if reload else None
    _, buffer, sup = _stack(pkg, root, clock, reg, reloader=reloader, **kw)
    segs = []
    for _ in range(segments):
        clock.advance(advance)
        segs.append(sup.run_segment_once())
    return SimpleNamespace(sup=sup, segs=segs, reg=reg, engine=engine, buffer=buffer,
                           parts=pkg.host(sup.particles))


@pytest.mark.parametrize("advance", [1.0, 2.5], ids=["one batch a segment", "bursts"])
def test_supervisor_segments_match_jax(tmp_path, advance):
    """Ingest, train, checkpoint and hot-reload, segment by segment: the
    records equal JAX's (reload step, watermark and freshness on the shared
    manual clock), the particles at RTOL / ATOL, the served generation's tag
    and the stream metrics equal."""
    runs = {name: _drive(make(), tmp_path / name, segments=5, advance=advance)
            for name, make in PKGS.items()}
    p, j = runs["port"], runs["jax"]
    assert _records(p.segs) == _records(j.segs)
    assert [s["reload_step"] for s in p.segs] == [s["t"] for s in p.segs]
    np.testing.assert_allclose(p.parts, j.parts, rtol=RTOL, atol=ATOL)
    assert p.engine.stats()["ensemble_tag"] == j.engine.stats()["ensemble_tag"]
    for name in ("svgd_stream_segments_total", "svgd_stream_rows_total",
                 "svgd_stream_batches_total", "svgd_stream_dropped_total"):
        assert p.reg.counter(name).value() == j.reg.counter(name).value(), name
    for name in ("svgd_stream_corpus_rows", "svgd_stream_watermark",
                 "svgd_serving_watermark"):
        assert p.reg.gauge(name).value() == j.reg.gauge(name).value(), name
    assert (p.reg.histogram("svgd_freshness_seconds").summary()
            == j.reg.histogram("svgd_freshness_seconds").summary())


def test_run_stream_report_matches_jax(tmp_path):
    """``run_stream``'s report: JAX's keys and values, segment reports
    included (the particles' agreement is the previous test's)."""
    reports = {}
    for name, make in PKGS.items():
        pkg = make()
        reg = pkg.tel.MetricsRegistry()
        clock = ManualClock(3.0)  # three batches due at the first segment
        engine = _engine(pkg, reg)
        _, _, sup = _stack(pkg, tmp_path / name, clock, reg,
                           reloader=pkg.Reloader(engine, str(tmp_path / name)),
                           buffer_capacity=2)
        reports[name] = sup.run_stream(3)
        assert sup.stream_report is reports[name]
    p, j = reports["port"], reports["jax"]
    assert sorted(p) == sorted(j)
    strip = lambda r: {k: v for k, v in r.items() if k != "segment_reports"}  # noqa: E731
    assert strip(p) == strip(j)
    assert p["dropped"] == 1 and p["batches"] == 2  # capacity 2 of 3 due
    assert _records(p["segment_reports"]) == _records(j["segment_reports"])


def _calibrated_drift_run(pkg, root, warmup=6, after=8, flip_at=8):
    """Calibrate-then-arm (the drivers' protocol) on a manual clock: a
    never-trip guard over ``warmup`` segments, then 2 × the last-4 max of the
    check KSD, then a full label flip from ordinal ``flip_at`` (segment i
    ingests ordinal i).  Eight steps of 0.02 a segment, so that the flipped
    labels move the posterior within a few segments."""
    reg = pkg.tel.MetricsRegistry()
    clock = ManualClock(0.0)
    diag = pkg.tel.PosteriorDiagnostics(
        pkg.tel.DiagnosticsConfig(every_steps=1, row_chunk=32, max_points=32), registry=reg)
    source, _, sup = _stack(pkg, root, clock, reg, diag=diag, steps=8, refit_steps=24,
                            step_size=0.02)
    sup.drift_guard = pkg.Guard(max_ksd=float("inf"))
    ksds, segs = [], []
    for i in range(warmup + after):
        if i == warmup:
            # six digits, so that both packages arm the same threshold (the
            # breach reason prints it)
            sup.drift_guard = pkg.Guard(max_ksd=float(f"{2.0 * max(ksds[-4:]):.6g}"))
            source.faults = (pkg.DriftAt(flip_at, kind="label_flip", magnitude=1.0),)
        clock.advance(1.0)
        segs.append(sup.run_segment_once())
        g = reg.gauge("svgd_diag_ksd")
        ksds.append(float(g.value()) if g.has() else float("nan"))
    return SimpleNamespace(segs=segs, ksds=ksds, reg=reg, parts=pkg.host(sup.particles),
                           threshold=sup.drift_guard.max_ksd)


def test_label_flip_escalates_at_the_same_segment_as_jax(tmp_path):
    """The drift check judges the posterior against the corpus of its first
    check, as JAX's program does (here that check already sees a full
    ring): the calibrated threshold, every check's KSD, and the escalated
    segments equal JAX's; the flip is caught."""
    runs = {name: _calibrated_drift_run(make(), tmp_path / name)
            for name, make in PKGS.items()}
    p, j = runs["port"], runs["jax"]
    np.testing.assert_allclose(p.threshold, j.threshold, rtol=KSD_RTOL)
    np.testing.assert_allclose(p.ksds[1:], j.ksds[1:], rtol=KSD_RTOL)
    assert _records(p.segs) == _records(j.segs)
    refits = [s["segment"] for s in p.segs if s["refit"]]
    assert refits and min(refits) >= 8  # after the flipped ordinal is ingested
    assert all(s["drift"].startswith("posterior drift") for s in p.segs if s["refit"])
    assert p.reg.counter("svgd_stream_refits_total").value() == len(refits)
    np.testing.assert_allclose(p.parts, j.parts, rtol=RTOL, atol=ATOL)


def test_drift_check_pins_the_first_full_ring(tmp_path):
    """The drift check's reference corpus: the sampler's current corpus
    while the ring still tiles (a check with two or three of its four
    batches), then the corpus of the first check on a full ring, kept while
    later ingests rotate the ring (JAX's jit-baked closure, pinned only
    once the ring is full — ROADMAP C)."""
    pkg = _port()
    reg = pkg.tel.MetricsRegistry()
    clock = ManualClock(0.0)
    diag = pkg.tel.PosteriorDiagnostics(
        pkg.tel.DiagnosticsConfig(every_steps=1, row_chunk=32, max_points=32), registry=reg)
    _, _, sup = _stack(pkg, tmp_path, clock, reg, diag=diag, corpus=4 * ROWS)
    sup.drift_guard = pkg.Guard(max_ksd=float("inf"))
    theta = torch.as_tensor(_init(1)[0])

    def score_on(data):
        data = tuple(a.to(theta.dtype) for a in data)
        return torch.func.grad(sup.sampler._full_logp(data))(theta)

    pinned = None
    for seg in range(6):
        clock.advance(1.0)
        sup.run_segment_once()
        current = tuple(a.clone() for a in sup.sampler._data)
        if seg == 3:  # the first check on a full ring (ordinals 0-3)
            pinned = current
        if seg >= 1:
            assert torch.equal(diag._score_fn(theta), score_on(pinned or current)), seg
    assert sup._ring.written == 6 * ROWS
    assert not torch.equal(diag._score_fn(theta), sup._harness.score_fn(theta))


def test_drift_guard_settable_and_disarmed_like_jax(tmp_path):
    """An always-trip guard escalates the next segment to ``refit_steps``;
    ``None`` returns to incremental segments (JAX's test, on both)."""
    out = {}
    for name, make in PKGS.items():
        pkg = make()
        reg = pkg.tel.MetricsRegistry()
        clock = ManualClock(0.0)
        diag = pkg.tel.PosteriorDiagnostics(
            pkg.tel.DiagnosticsConfig(every_steps=1, row_chunk=32, max_points=32),
            registry=reg)
        _, _, sup = _stack(pkg, tmp_path / name, clock, reg, diag=diag)
        segs = []
        for guard in (None, pkg.Guard(max_ksd=-1.0), None):
            sup.drift_guard = guard
            assert sup.drift_guard is guard
            clock.advance(1.0)
            segs.append(sup.run_segment_once())
        out[name] = segs
    assert _records(out["port"]) == _records(out["jax"])
    assert [s["steps"] for s in out["port"]] == [2, 6, 2]


def test_kill_and_cold_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """Run A streams four segments; run B streams two, is dropped, and a
    fresh stack cold-resumes from B's root for two more on the same clock
    timeline: particles bitwise A's (``torch.equal``), the same step, stream
    cursor, watermark and ring; the resumed segment reports where it
    resumed from, as JAX's does."""
    pkg = _port()

    def run(root, n_segments, *, resume_first=False, t0=0.0):
        reg = pkg.tel.MetricsRegistry()
        clock = ManualClock(t0)
        _, buffer, sup = _stack(pkg, root, clock, reg)
        segs = []
        for i in range(n_segments):
            clock.advance(1.0)
            segs.append(sup.run_segment_once(resume=(resume_first and i == 0)))
        return sup, buffer, clock.t, segs

    sup_a, buf_a, _, segs_a = run(tmp_path / "a", 4)
    sup_b, _, t_kill, _ = run(tmp_path / "b", 2)
    del sup_b
    sup_r, buf_r, _, segs_r = run(tmp_path / "b", 2, resume_first=True, t0=t_kill)
    assert torch.equal(sup_r.particles, sup_a.particles)
    assert (sup_r.t, buf_r.next_ordinal) == (sup_a.t, buf_a.next_ordinal)
    assert sup_r._stream_watermark == sup_a._stream_watermark
    for u, v in zip(sup_r._ring.data(), sup_a._ring.data()):
        assert np.array_equal(u, v)
    assert segs_r[0]["resumed_from"] == 4 and segs_r[0]["batches"] == 1
    assert [s["t"] for s in segs_r] == [s["t"] for s in segs_a[2:]]

    # JAX's resume on the same script reports the same records
    jpkg = _jax()
    jrecs = []
    for root, n, resume, t0 in ((tmp_path / "jb", 2, False, 0.0),
                                (tmp_path / "jb", 2, True, t_kill)):
        reg = jpkg.tel.MetricsRegistry()
        clock = ManualClock(t0)
        _, _, jsup = _stack(jpkg, root, clock, reg)
        for i in range(n):
            clock.advance(1.0)
            jrecs.append(jsup.run_segment_once(resume=(resume and i == 0)))
    assert _records(segs_r) == _records(jrecs[2:])
    np.testing.assert_allclose(pkg.host(sup_r.particles), np.asarray(jsup.particles),
                               rtol=RTOL, atol=ATOL)


def test_rejected_reload_rolls_back_never_forward(tmp_path):
    """An impossible health floor: every generation is rejected, the engine
    keeps serving its first one, no freshness sample and no serving
    watermark — the records and engine counters equal JAX's."""
    out = {}
    for name, make in PKGS.items():
        pkg = make()
        reg = pkg.tel.MetricsRegistry()
        clock = ManualClock(0.0)
        engine = _engine(pkg, reg, reload_policy=pkg.ReloadPolicy(min_ess_frac=1.5,
                                                                  max_points=16))
        tag0 = engine.stats()["ensemble_tag"]
        _, _, sup = _stack(pkg, tmp_path / name, clock, reg,
                           reloader=pkg.Reloader(engine, str(tmp_path / name)))
        segs = []
        for _ in range(2):
            clock.advance(1.0)
            segs.append(sup.run_segment_once())
        st = engine.stats()
        assert st["ensemble_tag"] == tag0
        assert not reg.gauge("svgd_serving_watermark").has()
        out[name] = (_records(segs), st["reload_rejects"], st["reloads"])
    assert out["port"] == out["jax"]
    recs, rejects, reloads = out["port"]
    assert [r["reload_rejected"] for r in recs] == [True, True]
    assert [r["reload_step"] for r in recs] == [None, None]
    assert [r["freshness_s"] for r in recs] == [None, None]
    assert (rejects, reloads) == (2, 0)


def test_rollout_steps_once_a_segment_like_jax(tmp_path):
    """A reloader with a rollout: each segment offers its checkpoint
    instead of swapping it and drives one ``rollout.step()``; with no
    traffic the candidate holds in shadow, so no freshness sample is taken.
    The decisions, records and report counts equal JAX's."""
    out = {}
    for name, make in PKGS.items():
        pkg = make()
        reg = pkg.tel.MetricsRegistry()
        clock = ManualClock(0.0)
        engine = _engine(pkg, reg)
        engine.warmup()
        plan = pkg.Plan(shadow_fraction=0.5, shadow_min_mirrors=1, shadow_hold_s=0.0,
                        canary_stages=(1.0,), stage_hold_s=0.0, stage_min_requests=1)
        rollout = pkg.Controller(engine, plan=plan, clock=clock)
        calls = []
        step = rollout.step
        rollout.step = lambda *a, **kw: calls.append(1) or step(*a, **kw)
        reloader = pkg.Reloader(engine, str(tmp_path / name), rollout=rollout)
        _, _, sup = _stack(pkg, tmp_path / name, clock, reg, reloader=reloader)
        sup.run_stream(4)
        assert len(calls) == 4
        rep = sup.stream_report
        out[name] = (_records(rep["segment_reports"]), rep["promotions"],
                     rep["rollout_rollbacks"], rep["freshness_s"], rep["reloads"],
                     engine.stats()["reloads"])
    assert out["port"] == out["jax"]
    recs, promotions, rollbacks, freshness, offers, swaps = out["port"]
    assert (promotions, rollbacks, freshness, offers, swaps) == (0, 0, [], 4, 0)
    assert [r["rollout"]["action"] for r in recs] == ["hold"] * 4


def test_metric_and_span_names_match_jax(tmp_path):
    """Under the tracer, a drift trip and a reload: the stream metric names,
    the ``stream.lifetime`` lane tree's span names and the drift instant
    equal JAX's, letter for letter."""
    names = {}
    for name, make in PKGS.items():
        pkg = make()
        trace = pkg.trace
        clock = ManualClock(0.0)
        trace.enable(clock=clock)
        try:
            reg = pkg.tel.MetricsRegistry()
            diag = pkg.tel.PosteriorDiagnostics(
                pkg.tel.DiagnosticsConfig(every_steps=1, row_chunk=32, max_points=32),
                registry=reg)
            engine = _engine(pkg, reg)
            _, _, sup = _stack(pkg, tmp_path / name, clock, reg, diag=diag,
                               reloader=pkg.Reloader(engine, str(tmp_path / name)))
            sup.drift_guard = pkg.Guard(max_ksd=-1.0)
            for _ in range(2):
                clock.advance(1.0)
                sup.run_segment_once()
        finally:
            tracer = trace.disable()
        # JAX's tracer also records its own compiles (jaxpr_trace,
        # xla_compile), which the port has no counterpart of
        span_names = sorted({e["name"] for e in tracer.chrome_events() if e["ph"] != "M"}
                            - {"jaxpr_trace", "xla_compile"})
        metric_names = sorted(n for n in reg.dump()["metrics"]
                              if n.startswith(("svgd_stream", "svgd_freshness",
                                               "svgd_serving_watermark")))
        names[name] = (span_names, metric_names)
    assert names["port"] == names["jax"]
    spans, metrics = names["port"]
    for span in ("stream.lifetime", "ingest", "train.segment", "ckpt", "reload",
                 "stream.drift_trip"):
        assert span in spans
    assert "svgd_freshness_seconds" in metrics and "svgd_stream_refits_total" in metrics


def _refusal_cases(pkg, tmp_path):
    lik, prior = pkg.split()
    data = (np.zeros((8, DIM), np.float32), np.ones((8,), np.float64))
    mb = lambda: pkg.sampler(DIM + 1, lik, data, 4, prior, 0)  # noqa: E731
    if pkg.name == "port":
        full = tdt.Sampler(DIM + 1, lik, data=data, log_prior=prior, device="cpu")
        dist = tdt.DistSampler(2, lik, None, _init(8), data=data, device="cpu",
                               include_wasserstein=False)
    else:
        full = jdt.Sampler(DIM + 1, lik, data=(jnp.asarray(data[0]), jnp.asarray(data[1])),
                           log_prior=prior)
        dist = jdt.DistSampler(2, lik, None, jnp.asarray(_init(8)),
                               data=(jnp.asarray(data[0]), jnp.asarray(data[1])),
                               include_wasserstein=False)
    ring = pkg.stream.RowRing(8, DIM)
    buf = pkg.stream.StreamBuffer(pkg.stream.GrowingCorpusStream(batch_rows=4, dim=DIM), 4,
                                  registry=pkg.tel.MetricsRegistry())
    root = str(tmp_path / pkg.name)
    S = pkg.stream.StreamingSupervisor
    return [
        lambda: S(dist, 0.05, buffer=buf, ring=ring, steps_per_segment=2,
                  checkpoint_dir=root, n=8),
        lambda: S(full, 0.05, buffer=buf, ring=ring, steps_per_segment=2,
                  checkpoint_dir=root, n=8),
        lambda: S(mb(), 0.05, buffer=buf, ring=ring, steps_per_segment=0,
                  checkpoint_dir=root, n=8),
        lambda: S(mb(), 0.05, buffer=buf, ring=ring, steps_per_segment=4, refit_steps=2,
                  checkpoint_dir=root, n=8),
        lambda: S(mb(), 0.05, buffer=buf, ring=ring, steps_per_segment=2, n=8),
        lambda: S(mb(), 0.05, buffer=buf, ring=ring, steps_per_segment=2,
                  checkpoint_dir=root, n=8).run_stream(0),
    ]


def test_supervisor_refusals_match_jax(tmp_path):
    """A DistSampler (TypeError, "not wired yet"), a full-data sampler, a
    zero segment, a re-fit shorter than a segment, no checkpointing, zero
    segments to stream: JAX's exception types and messages."""
    port = [_message(c) for c in _refusal_cases(_port(), tmp_path)]
    ref = [_message(c) for c in _refusal_cases(_jax(), tmp_path)]
    assert port == ref
    assert port[0][0] == "TypeError" and "not wired yet" in port[0][1]
    assert all(kind == "ValueError" for kind, _ in port[1:])


def test_float32_run_keeps_float64_labels_and_float32_particles(tmp_path):
    """The ring keeps y as float64 and every ``set_data`` takes its copies
    (the spec check passes each segment); a float32 run's particles and
    scores stay float32."""
    pkg = _port()
    reg = pkg.tel.MetricsRegistry()
    clock = ManualClock(0.0)
    _, _, sup = _stack(pkg, tmp_path, clock, reg, init=_init().astype(np.float32))
    for _ in range(3):
        clock.advance(1.0)
        sup.run_segment_once()
    x, y = sup.sampler._data
    assert (x.dtype, y.dtype) == (torch.float32, torch.float64)
    assert sup.particles.dtype == torch.float32
    assert sup._harness.score_fn(sup.particles[0]).dtype == torch.float32


def test_package_names_match_jax():
    assert tstream.__all__ == jstream.__all__
    for name in tstream.__all__:
        assert getattr(tstream, name).__name__ == getattr(jstream, name).__name__


def test_streaming_checkpoint_keys_match_jax(tmp_path):
    """A streaming checkpoint carries JAX's keys, and its stream entries'
    values and dtypes equal JAX's."""
    runs = {name: _drive(make(), tmp_path / name, segments=2, reload=False)
            for name, make in PKGS.items()}
    states = {name: r.sup._state_with_meta() for name, r in runs.items()}
    assert sorted(states["port"]) == sorted(states["jax"])
    for k in states["jax"]:
        if k.startswith("stream"):
            a, b = np.asarray(states["port"][k]), np.asarray(states["jax"][k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k
