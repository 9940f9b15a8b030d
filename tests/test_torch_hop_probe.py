"""The hop probe (``dist_svgd_torch/tools/hop_probe.py``) on the CPU, over
an in-process port ``PredictionServer`` with the probe's arms patched in:
each arm's replies are the engine's, the per-request arm opens one
connection a request and the keep-alive arms none after their warm-up,
and the patch writes a reply in one or two writes with ``TCP_NODELAY`` set
or cleared as the arm says, and undoes cleanly."""

import json
import socket
import socketserver

import numpy as np
import pytest

from dist_svgd_torch.serving import PredictionServer, PredictiveEngine
from dist_svgd_torch.serving import fleet as tfleet
from dist_svgd_torch.tools import hop_probe

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def patched_server():
    rng = np.random.default_rng(27)
    parts = rng.normal(size=(64, 5)).astype(np.float32)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    engine = PredictiveEngine("logreg", parts, device="cpu", min_bucket=4, max_bucket=256)
    undo = hop_probe.patch_server_arms()
    srv = PredictionServer(engine, port=0, max_wait_ms=0.5).start()
    try:
        host, port = srv.address[:2]
        yield (host, int(port)), engine, x
    finally:
        srv.shutdown()
        undo()


def test_measure_runs_every_arm_and_counts_its_connections(patched_server):
    address, _, x = patched_server
    body = json.dumps({"inputs": x.tolist()}).encode()
    arms = hop_probe.measure(address, body, requests=4, rounds=2, warmup=1)
    assert list(arms) == list(hop_probe.ARMS)
    for arm, row in arms.items():
        assert row["requests"] == 8 and 0 < row["p50_ms"] <= row["p99_ms"]
        assert row["connections_opened"] == (8 if arm == "per_request" else 0), arm


@pytest.mark.parametrize("arm,writes,nodelay", [
    ("pooled", 1, True), ("per_request", 1, True), ("two_writes", 2, True),
    ("nagle", 1, False), ("two_writes_nagle", 2, False)])
def test_patched_replies_follow_the_arm(patched_server, monkeypatch, arm, writes, nodelay):
    address, engine, x = patched_server
    seen = []
    write = socketserver._SocketWriter.write

    def counted(self, data):
        seen.append(self._sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0)
        return write(self, data)

    monkeypatch.setattr(socketserver._SocketWriter, "write", counted)
    tr = tfleet.HttpTransport({"r0": address})
    reply = tr.request("r0", "POST", "/predict", body=json.dumps({"inputs": x.tolist()}).encode(),
                       headers={hop_probe.ARM_HEADER: arm})
    tr.close()
    assert reply.status == 200
    np.testing.assert_array_equal(np.asarray(reply.json()["outputs"]["mean"], np.float32),
                                  engine.predict(x)["mean"])
    assert seen == [nodelay] * writes


def test_undo_restores_the_one_write_reply():
    send_reply = tfleet._KeepAliveHandler.send_reply
    undo = hop_probe.patch_server_arms()
    assert tfleet._KeepAliveHandler.send_reply is not send_reply
    undo()
    assert tfleet._KeepAliveHandler.send_reply is send_reply
