"""The native ``/predict`` body decode (``dist_svgd_torch/csrc/
predict_body.cpp`` through ``serving/predict_body.py``) against JAX's decode
of the same bytes, on the CPU with the host compiler.

- Every body the decoder accepts gives, bit for bit, JAX's
  ``np.asarray(json.loads(body)["inputs"], float32)`` (one row for a flat
  ``"inputs"``) and JAX's ``tenant``: hypothesis draws float32 and float64
  matrices and rows written by ``json.dumps(tolist())``, and token mixes
  with ints, exponents, ``-0``, subnormals and values past float32's and
  float64's range, under varied whitespace.
- Every mutated body (truncated, ragged, duplicate keys, escapes, NaN,
  leading zeros, …) is declined, and the port's server answers it with
  JAX's server's status and message (or JAX's result).
- The fleet router's front door routes every body, valid or not, on JAX's
  key.
- A second thread runs while the decoder works: the call releases the
  interpreter lock.
"""

import ctypes
import json
import string
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from dist_svgd_torch.ops import _build
from dist_svgd_torch.serving import ModelRegistry, PredictionServer, PredictiveEngine
from dist_svgd_torch.serving import fleet as tfleet
from dist_svgd_torch.serving import predict_body
from dist_svgd_torch.telemetry import metrics as tmetrics

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: float32 outputs of the two engines agree within this, relative
#: (``test_torch_serving.py``).
F32_RTOL = 1e-6
FEATURES = 4


def _jax_decode(body):
    """``dist_svgd_tpu/serving/server.py:_predict``'s decode, line for line."""
    doc = json.loads(body or b"null")
    with np.errstate(over="ignore"):  # 1e39 → inf warns; JAX's server lets it
        x = np.asarray(doc["inputs"], dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    return x, doc.get("tenant")


def _assert_bitwise(body):
    got = predict_body.decode(body)
    assert got is not None, body[:200]
    x, tenant = got
    want, want_tenant = _jax_decode(body)
    assert x.dtype == np.float32 and x.shape == want.shape
    np.testing.assert_array_equal(x.view(np.uint32), want.view(np.uint32))
    assert tenant == want_tenant


# --------------------------------------------------------------------- #
# accepted bodies: bitwise JAX's


WS = st.sampled_from(["", "", " ", "  ", "\n", "\t", "\r\n ", " \t\n"])
TENANT = st.text(alphabet=[c for c in string.printable
                           if c.isprintable() and c not in '"\\'], max_size=12)
SPECIAL = ("1e39", "-1e39", "1e400", "-1e400", "1e-400", "-1e-400", "-0", "-0.0", "0",
           "0.0", "-0e7", "4.9e-324", "2.2250738585072014e-308", "1e-45", "1.4e-45",
           "7e-46", "-1.401298464324817e-45", "1.1754942e-38", "3.4028234663852886e+38",
           "3.4028235677973366e+38", "3.4028236e38", "1E5", "1e+5", "1E-0", "12345678901234",
           "-999999999999999", "100000000000000", "0.1", "16777217", "-16777217",
           "9007199254740993e0", "0.30000000000000004", "123456789.98765432123456789",
           # just above float32's halfway between 1 and its successor: the
           # double rounds to the halfway, whose float32 is 1 (ties to even)
           "1.0000000596046448", "-1.0000000596046448")
TOKEN = st.one_of(
    st.floats(width=32, allow_nan=False, allow_infinity=False).map(lambda v: json.dumps(float(v))),
    st.floats(allow_nan=False, allow_infinity=False).map(json.dumps),
    st.integers(-(10 ** 15) + 1, 10 ** 15 - 1).map(str),
    st.sampled_from(SPECIAL),
    st.builds(lambda m, f, e, sep: f"{m}.{f}{sep}{e}", st.integers(-99999, 99999),
              st.integers(0, 10 ** 9), st.integers(-420, 420), st.sampled_from("eE")),
)


def _body(inputs_text, tenant, tenant_first, ws):
    members = [f'"inputs"{ws()}:{ws()}{inputs_text}']
    if tenant is not None:
        members.insert(0 if tenant_first else 1, f'"tenant"{ws()}:{ws()}"{tenant}"')
    return (ws() + "{" + ",".join(ws() + m + ws() for m in members) + "}" + ws()).encode()


@settings(max_examples=250, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_token_mixes_decode_bitwise_as_jax(data):
    flat = data.draw(st.booleans())
    rows = 1 if flat else data.draw(st.integers(1, 5))
    cols = data.draw(st.integers(1, 6))
    toks = data.draw(st.lists(TOKEN, min_size=rows * cols, max_size=rows * cols))

    def ws():
        return data.draw(WS)

    def arr(items):
        return "[" + ",".join(f"{ws()}{t}{ws()}" for t in items) + "]"

    text = (arr(toks) if flat else
            "[" + ",".join(ws() + arr(toks[i * cols:(i + 1) * cols]) + ws()
                           for i in range(rows)) + "]")
    body = _body(text, data.draw(st.none() | TENANT), data.draw(st.booleans()), ws)
    _assert_bitwise(body)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_matrices_written_by_json_dumps_decode_bitwise_as_jax(dtype, data):
    """A client's body, ``json.dumps({"inputs": m.tolist(), ...})``, of a
    float32 or float64 matrix or one row (subnormals and -0 included)."""
    shape = data.draw(st.sampled_from([(1,), (7,), (1, 1), (3, 5), (8, 2), (4, 9)]))
    width = 32 if dtype == np.float32 else 64
    m = data.draw(hnp.arrays(dtype, shape, elements=st.floats(
        width=width, allow_nan=False, allow_infinity=False)))
    doc = {"inputs": m.tolist()}
    tenant = data.draw(st.none() | TENANT)
    if tenant is not None:
        doc["tenant"] = tenant
    indent = data.draw(st.sampled_from([None, 0, 2]))
    _assert_bitwise(json.dumps(doc, indent=indent).encode())


def test_a_fleet_request_decodes_bitwise_as_jax():
    """The fleet phase's body: 128 × 55 float32 Covertype-shaped rows,
    17 significant digits a number."""
    x = np.random.default_rng(0).normal(size=(128, 55)).astype(np.float32)
    x[0, :5] = [0.0, -0.0, 1e-40, -3.4e38, 1.0]
    body = json.dumps({"inputs": x.tolist()}).encode()
    _assert_bitwise(body)
    got, tenant = predict_body.decode(body)
    np.testing.assert_array_equal(got, x)
    assert tenant is None and predict_body.routing_key(body) == ""


# --------------------------------------------------------------------- #
# declined bodies: JAX's status and message through the port's server


ROW = "[0.5, -1.25, 3.0, 2.0]"
VALID = ('{"inputs": [' + ROW + ', [1e-3, 2, -0.0, 7.5]]}').encode()
MUTATED = {
    "ragged": '{"inputs": [[1, 2, 3, 4], [1, 2, 3]]}',
    "ragged_scalar": '{"inputs": [[1, 2, 3, 4], 5]}',
    "row_then_scalar": '{"inputs": [1, [2, 3, 4, 5]]}',
    "duplicate_inputs": '{"inputs": [[9, 9, 9]], "inputs": [' + ROW + ']}',
    "duplicate_tenant": '{"tenant": "a", "inputs": [' + ROW + '], "tenant": "b"}',
    "escaped_key": '{"inp\\u0075ts": [' + ROW + ']}',
    "escaped_tenant": '{"inputs": [' + ROW + '], "tenant": "a\\nb"}',
    "nan": '{"inputs": [[NaN, 1, 2, 3]]}',
    "infinity": '{"inputs": [[Infinity, -Infinity, 1, 2]]}',
    "leading_zero": '{"inputs": [[01, 2, 3, 4]]}',
    "negative_leading_zero": '{"inputs": [[-01.5, 2, 3, 4]]}',
    "plus_sign": '{"inputs": [[+1, 2, 3, 4]]}',
    "bare_fraction": '{"inputs": [[.5, 2, 3, 4]]}',
    "bare_point": '{"inputs": [[5., 2, 3, 4]]}',
    "bare_exponent": '{"inputs": [[5e, 2, 3, 4]]}',
    "sixteen_digit_int": '{"inputs": [[1234567890123456, 2, 3, 4]]}',
    "huge_int": '{"inputs": [[1' + "0" * 40 + ', 2, 3, 4]]}',
    "trailing_comma": '{"inputs": [[1, 2, 3, 4,]]}',
    "trailing_member_comma": '{"inputs": [' + ROW + '],}',
    "extra_key": '{"inputs": [' + ROW + '], "meta": 1}',
    "empty_inputs": '{"inputs": []}',
    "empty_row": '{"inputs": [[]]}',
    "three_levels": '{"inputs": [[' + ROW + ']]}',
    "top_level_array": '[' + ROW + ']',
    "no_inputs": '{"tenant": "a"}',
    "null_inputs": '{"inputs": null}',
    "object_inputs": '{"inputs": {"a": 1}}',
    "null_tenant": '{"inputs": [' + ROW + '], "tenant": null}',
    "number_tenant": '{"inputs": [' + ROW + '], "tenant": 7}',
    "bool_value": '{"inputs": [[true, 1, 2, 3]]}',
    "string_value": '{"inputs": [["1", 2, 3, 4]]}',
    "control_char_tenant": '{"inputs": [' + ROW + '], "tenant": "a\x01"}',
    "non_ascii_tenant": '{"inputs": [' + ROW + '], "tenant": "café"}',
    "unterminated_tenant": '{"inputs": [' + ROW + '], "tenant": "a',
    "trailing_garbage": VALID.decode() + " x",
    "vertical_tab": '{"inputs":\x0b[' + ROW + ']}',
    "empty_body": "",
    "null_body": "null",
}


def _bodies():
    for name, text in MUTATED.items():
        yield name, text.encode()
    yield "bom", b"\xef\xbb\xbf" + VALID
    yield "utf16", VALID.decode().encode("utf-16-le")
    for cut in range(len(VALID)):
        yield f"truncated_{cut}", VALID[:cut]


BODIES = dict(_bodies())


def _outcome(server, body):
    """``_predict``'s status and payload, or the exception it raised."""
    try:
        code, payload, rows, tenant, headers = server._predict(body)
    except Exception as e:  # a body JAX's server does not map either
        return ("raised", type(e).__name__, str(e))
    return code, payload, rows, tenant, headers


@pytest.fixture(scope="module")
def servers():
    from dist_svgd_tpu.serving import PredictionServer as JServer
    from dist_svgd_tpu.serving import PredictiveEngine as JEngine

    parts = np.random.default_rng(3).normal(size=(16, 1 + FEATURES)).astype(np.float32)
    ours = PredictionServer(PredictiveEngine("logreg", parts, device="cpu", min_bucket=4,
                                             max_bucket=16), port=0, max_wait_ms=0.5)
    theirs = JServer(JEngine("logreg", parts, min_bucket=4, max_bucket=16), port=0,
                     max_wait_ms=0.5)
    with ours, theirs:
        yield ours, theirs


def _assert_same_outcome(ours, theirs):
    if ours[0] == "raised" or theirs[0] == "raised":
        assert ours == theirs
        return
    assert ours[0] == theirs[0] and ours[2:] == theirs[2:]
    if ours[0] != 200:
        assert ours[1] == theirs[1]
        return
    assert sorted(ours[1]) == sorted(theirs[1])
    for key, ours_out in ours[1]["outputs"].items():
        np.testing.assert_allclose(np.asarray(ours_out, np.float64),
                                   np.asarray(theirs[1]["outputs"][key], np.float64),
                                   rtol=F32_RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize("family", ["mutated", "truncated"])
def test_declined_bodies_get_jax_status_and_message(servers, family):
    ours, theirs = servers
    names = [n for n in BODIES if n.startswith("truncated_") == (family == "truncated")]
    assert len(names) > 30
    decode = ours.registry.get("svgd_predict_decode_total")
    for name in names:
        body = BODIES[name]
        assert predict_body.decode(body) is None, name
        before = decode.value(path="json")
        _assert_same_outcome(_outcome(ours, body), _outcome(theirs, body))
        assert decode.value(path="json") == before + 1, name


def test_accepted_body_gets_jax_answer_and_counts_native(servers):
    ours, theirs = servers
    decode = ours.registry.get("svgd_predict_decode_total")
    for body in (VALID, b'{"inputs": ' + ROW.encode() + b"}",
                 b'{"inputs": [' + ROW.encode() + b'], "tenant": "a"}'):
        before = decode.value(path="native")
        _assert_same_outcome(_outcome(ours, body), _outcome(theirs, body))
        assert decode.value(path="native") == before + 1


def test_multi_tenant_server_routes_native_bodies_as_jax():
    """Against a registry the natively read tenant routes as JAX's does: to
    its engine, 404 for an unknown one, 400 (hosted names) without one."""
    from dist_svgd_tpu.serving import ModelRegistry as JRegistry
    from dist_svgd_tpu.serving import PredictionServer as JServer

    rng = np.random.default_rng(5)
    ours_reg = ModelRegistry(max_wait_ms=0.5, metrics=tmetrics.MetricsRegistry())
    theirs_reg = JRegistry(max_wait_ms=0.5)
    for name in ("alpha", "beta"):
        parts = rng.normal(size=(8, 1 + FEATURES)).astype(np.float32)
        ours_reg.add_tenant(name, "logreg", particles=parts, device="cpu")
        theirs_reg.add_tenant(name, "logreg", particles=parts)
    with PredictionServer(ours_reg, port=0) as ours, JServer(theirs_reg, port=0) as theirs:
        decode = ours.registry.get("svgd_predict_decode_total")
        for tenant in ('"alpha"', '"beta"', '"ghost"', '""', None):
            body = ('{"inputs": [' + ROW + ']'
                    + ("" if tenant is None else f', "tenant": {tenant}') + "}").encode()
            assert predict_body.decode(body) is not None
            _assert_same_outcome(_outcome(ours, body), _outcome(theirs, body))
        assert decode.value(path="native") == 5 and decode.value(path="json") == 0


# --------------------------------------------------------------------- #
# the router's front door


def _front_door_keys(side_fleet, bodies):
    """The tenant key a front door hands ``route`` for each body (the
    route itself replaced by a recorder)."""
    reps = {"r0": side_fleet.LoopbackReplica("r0")}
    tr = side_fleet.FakeTransport(reps)
    router = side_fleet.FleetRouter(list(reps), transport=tr, probe_interval_s=5.0, port=0)
    seen = []

    def record(tenant, body, **_):
        seen.append(tenant)
        return types.SimpleNamespace(status=200, headers={"Content-Type": "application/json"},
                                     body=b"{}")

    router.route = record
    router.start()
    keys = []
    try:
        for body in bodies:
            del seen[:]
            req = urllib.request.Request(router.url + "/predict", body,
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                r.read()
            keys.append(seen[0])
    finally:
        router.shutdown()
    return keys


def test_front_door_routing_key_equals_jax():
    from dist_svgd_tpu.serving import fleet as jfleet

    bodies = [VALID, b'{"tenant": "t3", "inputs": [[1]]}', b'{"inputs": [1], "tenant": ""}',
              b'{"tenant": "web tenant", "inputs": [[1, 2], [3, 4]]}',
              b'{"tenant": "a\\u0062", "inputs": [[1]]}', b'{"tenant": 0, "inputs": [[1]]}',
              b'{"tenant": 1.5, "inputs": [[1]]}', b'{"tenant": "x", "inputs": [[NaN]]}',
              b'{"tenant": "x", "inputs": [[1],]}', b'{"tenant": "y"}', b'["tenant"]',
              *(BODIES[n] for n in BODIES if not n.startswith("truncated_")),
              *((b'{"tenant": "z", ' + VALID[1:])[:cut] for cut in range(0, 40, 3))]
    ours, theirs = _front_door_keys(tfleet, bodies), _front_door_keys(jfleet, bodies)
    assert ours == theirs
    assert [predict_body.routing_key(b) for b in bodies] == theirs
    assert {"t3", "web tenant", "ab", 1.5, "x", "y"} <= {
        k for k in theirs if not isinstance(k, list)}


# --------------------------------------------------------------------- #
# the interpreter lock, and the build


def _progress_during(fn, body):
    """Seconds a counting thread ran inside ``fn(body)``'s call, over the
    call's wall."""
    stamps, stop = [], threading.Event()

    def count():
        n = 0
        while not stop.is_set():
            n += 1
            if n % 200 == 0:
                stamps.append(time.perf_counter())

    th = threading.Thread(target=count)
    th.start()
    try:
        time.sleep(0.02)
        t0 = time.perf_counter()
        fn(body)
        t1 = time.perf_counter()
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive()
    inside = [t for t in stamps if t0 <= t <= t1]
    return (inside[-1] - inside[0] if len(inside) > 1 else 0.0), t1 - t0


def test_decode_releases_the_interpreter_lock():
    x = np.random.default_rng(1).normal(size=(10000, 55)).astype(np.float32)
    body = json.dumps({"inputs": x.tolist()}).encode()
    ran, wall = _progress_during(predict_body.decode, body)
    assert wall > 0.01 and ran > 0.5 * wall, (ran, wall)
    # the same library called with the lock held (ctypes.PyDLL) starves
    # the counter: the measure tells the two apart
    held = ctypes.PyDLL(str(_build.library_path("predict_body"))).predict_body_decode
    held.argtypes = predict_body.load().predict_body_decode.argtypes
    buf = np.empty(len(body) // 2 + 1, np.float32)
    shape, tenant = predict_body._I64x2(), predict_body._I64x2()
    ran_held, wall_held = _progress_during(
        lambda b: held(b, len(b), buf.ctypes.data, buf.size, shape, tenant), body)
    assert ran_held < 0.5 * wall_held, (ran_held, wall_held)


def test_host_build_is_hashed_counted_apart_and_refuses_a_missing_compiler(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = (_build.CSRC / "predict_body.cpp").read_text()
    (csrc / "predict_body.cpp").write_text(src + "\n// another version\n")
    assert _build.source_digest("predict_body", csrc) != _build.source_digest("predict_body")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.builds_total()
    res = _build.build(["predict_body"], csrc=csrc)["predict_body"]
    assert not res.cached and res.path.parent == tmp_path / "build"
    assert res.path.name == f"libpredict_body-{_build.source_digest('predict_body', csrc)}.so"
    assert _build.builds_total() == before  # not a kernel build
    assert _build.build(["predict_body"], csrc=csrc)["predict_body"].cached
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="c\\+\\+ not found"):
        _build.find_cxx()


# --------------------------------------------------------------------- #
# the account's tools: the decode timing and the per-thread profiler


def test_decode_cost_times_both_decodes_of_the_fleet_bodies():
    from dist_svgd_torch.tools import hop_probe

    bodies = hop_probe.fleet_bodies(requests=6, rows=128, nrows=2000)
    assert len(bodies) == 6 and all(b.startswith(b'{"inputs": [[') for b in bodies)
    arms = hop_probe.decode_cost(bodies, rounds=2)
    assert set(arms) == {"json", "native"}
    for row in arms.values():
        assert len(row["cpu_ms_rounds"]) == len(row["wall_ms_rounds"]) == 2
        assert row["wall_ms_a_body"] > 0


def _spin(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_thread_sampler_charges_a_busy_thread_to_its_function():
    from dist_svgd_torch.tools.thread_profile import ThreadSampler

    sampler = ThreadSampler(interval_s=0.002, active=False).start()
    try:
        th = threading.Thread(target=_spin, args=(0.1,), name="warm-7")
        th.start()
        th.join(timeout=10)
        sampler.toggle()  # on: what ran before is cleared
        th = threading.Thread(target=_spin, args=(0.4,), name="busy-12")
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        time.sleep(0.02)
    finally:
        sampler.stop()
    rep = sampler.report()
    threads = dict((k, v) for k, v, _ in rep["by_thread"])
    assert "busy-N" in threads and "warm-N" not in threads
    assert threads["busy-N"] > 0.2 and rep["samples"] > 10
    top = rep["self"][0][0]
    assert top.endswith("(_spin)") and "test_torch_predict_body.py" in top


def test_thread_profile_runs_a_module_and_writes_its_report(tmp_path):
    import subprocess
    import sys

    out = tmp_path / "profile.json"
    script = _build.CSRC.parent / "tools" / "thread_profile.py"
    proc = subprocess.run([sys.executable, str(script), "--out", str(out), "--", "-m",
                           "timeit", "-n", "3", "sum(range(300000))"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(out.read_text())
    assert {"wall_s", "cpu_s", "by_thread", "self", "inclusive"} <= set(rep)
    assert rep["wall_s"] > 0 and rep["samples"] > 0
