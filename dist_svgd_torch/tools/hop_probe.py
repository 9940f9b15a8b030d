"""The router→replica hop alone: sequential ``POST /predict`` round trips
from an :class:`~dist_svgd_torch.serving.fleet.HttpTransport` in this
process to one port replica process (``python -m
dist_svgd_torch.serving.server`` over a seeded logreg ensemble), under five
arms interleaved in rounds (the order rotates a round):

- ``pooled``: the shipped path — a keep-alive connection, each reply one
  write, ``TCP_NODELAY`` on the replica's socket;
- ``per_request``: a new connection a request (the pool closed after each;
  what JAX's transport does);
- ``two_writes``: the reply's headers and body in two writes, ``TCP_NODELAY``
  on;
- ``nagle``: one write, ``TCP_NODELAY`` off on the replica's socket;
- ``two_writes_nagle``: both off (the keep-alive hazard: a small second
  write waits for the client's delayed ACK).

``--decode-cost`` instead times, on this host's CPU, the two decodes of a
``/predict`` body the port's replica has (:func:`decode_cost`): JAX's
``json.loads`` + ``np.asarray`` and the native decoder
(``serving/predict_body.py``), each over the fleet phase's 128-row
Covertype bodies, in rounds that alternate the order::

    python -m dist_svgd_torch.tools.hop_probe --decode-cost [--rounds 5]

The replica runs with :func:`patch_server_arms` applied, which takes each
request's arm from its :data:`ARM_HEADER`.  The client's sockets have
``TCP_NODELAY`` in every arm (``http.client`` sets it) and send a request
in one write.  It prints one JSON line: each arm's p50 / p99 / mean ms and
the connections opened.  The card unless ``--device cpu``::

    python -m dist_svgd_torch.tools.hop_probe [--requests 200] [--rounds 3]
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

#: The request header that names a request's arm to the patched replica.
ARM_HEADER = "X-Hop-Arm"
ARMS = ("pooled", "per_request", "two_writes", "nagle", "two_writes_nagle")


def patch_server_arms():
    """Make ``_KeepAliveHandler.send_reply`` follow each request's
    :data:`ARM_HEADER`: ``TCP_NODELAY`` set or cleared on the connection,
    the reply in one write or in two (headers, then body).  Returns the
    function that undoes it."""
    from dist_svgd_torch.serving import fleet

    send_reply = fleet._KeepAliveHandler.send_reply

    class _SplitWriter:
        def __init__(self, wfile):
            self._wfile = wfile

        def write(self, data):
            head, sep, body = data.partition(b"\r\n\r\n")
            self._wfile.write(head + sep)
            return self._wfile.write(body)

    def patched(self, code, headers, body):
        arm = self.headers.get(ARM_HEADER, "pooled")
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                   0 if arm.endswith("nagle") else 1)
        if not arm.startswith("two_writes"):
            return send_reply(self, code, headers, body)
        wfile, self.wfile = self.wfile, _SplitWriter(self.wfile)
        try:
            return send_reply(self, code, headers, body)
        finally:
            self.wfile = wfile

    fleet._KeepAliveHandler.send_reply = patched

    def undo():
        fleet._KeepAliveHandler.send_reply = send_reply

    return undo


def measure(address, body, requests=200, rounds=3, warmup=10):
    """Time ``requests`` sequential round trips an arm a round over one
    transport to ``address``; every reply must be 200."""
    from dist_svgd_torch.serving.fleet import HttpTransport

    tr = HttpTransport({"r0": address})
    walls = {arm: [] for arm in ARMS}
    opened = {arm: 0 for arm in ARMS}
    for i in range(rounds):
        for arm in ARMS[i % len(ARMS):] + ARMS[:i % len(ARMS)]:
            headers = {"Content-Type": "application/json", ARM_HEADER: arm}
            for j in range(warmup + requests):
                before = tr.connections_opened
                t0 = time.perf_counter()
                reply = tr.request("r0", "POST", "/predict", body=body,
                                   headers=headers, timeout_s=30.0)
                wall = time.perf_counter() - t0
                if reply.status != 200:
                    raise RuntimeError(f"{arm}: HTTP {reply.status} {reply.body[:200]!r}")
                if arm == "per_request":
                    tr.close()
                if j >= warmup:
                    walls[arm].append(wall)
                    opened[arm] += tr.connections_opened - before
    tr.close()

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))] * 1e3

    return {arm: {"p50_ms": pct(w, 0.5), "p99_ms": pct(w, 0.99),
                  "mean_ms": statistics.fmean(w) * 1e3, "requests": len(w),
                  "connections_opened": opened[arm]}
            for arm, w in walls.items()}


def _json_decode(body):
    """The JAX server's decode of a body."""
    x = np.asarray(json.loads(body)["inputs"], dtype=np.float32)
    return x[None, :] if x.ndim == 1 else x


def decode_cost(bodies, rounds=5):
    """Thread CPU and wall ms a body of each decode (``json``: JAX's;
    ``native``: the port's), summed over every body in a round (the card
    host's CPU clocks tick in 10 ms, so a body alone cannot be timed), the
    order alternating a round; the two must agree bitwise."""
    from dist_svgd_torch.serving import predict_body

    arms = {"json": _json_decode, "native": lambda b: predict_body.decode(b)[0]}
    for body in bodies:
        a, b = (arms[k](body) for k in ("json", "native"))
        if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            raise RuntimeError("the two decodes disagree")
    cpu = {k: [] for k in arms}
    wall = {k: [] for k in arms}
    for i in range(rounds):
        for arm in (("json", "native") if i % 2 == 0 else ("native", "json")):
            fn = arms[arm]
            c0, w0 = time.thread_time(), time.perf_counter()
            for body in bodies:
                fn(body)
            cpu[arm].append((time.thread_time() - c0) / len(bodies) * 1e3)
            wall[arm].append((time.perf_counter() - w0) / len(bodies) * 1e3)
    return {arm: {"cpu_ms_a_body": statistics.median(cpu[arm]),
                  "wall_ms_a_body": statistics.median(wall[arm]),
                  "cpu_ms_rounds": cpu[arm], "wall_ms_rounds": wall[arm]}
            for arm in arms}


def fleet_bodies(requests=320, rows=128, nrows=20_000, seed=0):
    """The fleet phase's request bodies: ``json.dumps({"inputs": ...})`` of
    the Covertype test rows in ``rows``-row chunks, cycled to
    ``requests``."""
    from dist_svgd_torch.utils.datasets import load_covertype

    x, _ = load_covertype(nrows, seed=seed)
    x_test = x[-max(nrows // 10, 1):].astype(np.float32)
    chunks = [json.dumps({"inputs": x_test[i:i + rows].tolist()}).encode()
              for i in range(0, len(x_test), rows)]
    return [chunks[j % len(chunks)] for j in range(requests)]


def _serve(argv):
    """The replica process: the server's own ``main`` with the arms
    patched in."""
    from dist_svgd_torch.serving import server

    patch_server_arms()
    return server.main(argv)


def run(device=None, requests=200, rounds=3, rows=128, n=10_000, d=55, seed=0,
        startup_s=240.0):
    """Spawn the patched replica over a seeded ``n × d`` logreg ensemble,
    measure, stop it; returns the row."""
    from dist_svgd_torch.serving.fleet import HttpTransport, TransportError
    from dist_svgd_torch.utils.checkpoint import save_state
    from dist_svgd_torch.utils.ports import listen_port

    rng = np.random.default_rng(seed)
    body = json.dumps({"inputs": rng.normal(size=(rows, d - 1)).astype(
        np.float32).tolist()}).encode()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_state(ckpt, {"particles": rng.normal(size=(n, d)).astype(np.float32) * 0.1,
                          "t": 1}, backend="npz")
        address = ("127.0.0.1", listen_port())
        cmd = [sys.executable, "-m", "dist_svgd_torch.tools.hop_probe", "--serve",
               "--checkpoint", ckpt, "--model", "logreg", "--host", address[0],
               "--port", str(address[1]), "--max-batch", str(rows)]
        if device is not None:
            cmd += ["--device", device]
        with open(os.path.join(tmp, "replica.log"), "wb") as log:
            proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            probe, t0 = HttpTransport({"r0": address}), time.monotonic()
            while True:
                try:
                    if probe.request("r0", "GET", "/healthz", timeout_s=1.0).status == 200:
                        break
                except TransportError:
                    pass
                if proc.poll() is not None or time.monotonic() - t0 > startup_s:
                    with open(os.path.join(tmp, "replica.log"), "rb") as fh:
                        tail = fh.read()[-2000:].decode(errors="replace")
                    raise RuntimeError(f"the replica never turned healthy:\n{tail}")
                time.sleep(0.2)
            probe.close()
            arms = measure(address, body, requests=requests, rounds=rounds)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
    return {"metric": "hop_probe", "device": device or "cuda", "rows": rows,
            "particles": n, "d": d, "requests_an_arm": requests * rounds,
            "rounds": rounds, "arms": arms}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--serve"]:
        return _serve(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--decode-cost", action="store_true")
    args = ap.parse_args(argv)
    if args.decode_cost:
        bodies = fleet_bodies(rows=args.rows)
        print(json.dumps({"metric": "decode_cost", "bodies": len(bodies),
                          "body_bytes": sum(map(len, bodies)) / len(bodies),
                          "arms": decode_cost(bodies, rounds=args.rounds)}), flush=True)
        return 0
    print(json.dumps(run(device=args.device, requests=args.requests, rounds=args.rounds,
                         rows=args.rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
