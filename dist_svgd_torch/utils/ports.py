"""Listening ports for the local processes the port's drills spawn.

A port found by binding to port 0 comes from the kernel's ephemeral range,
the same range that outgoing connections take their local ports from.  A
replica that is killed and restarted on its old port can then find the port
held by one of the router's own client sockets (open, or in TIME_WAIT for a
minute after its close) and fail to bind with ``EADDRINUSE``.  The ports
handed out here lie outside the ephemeral range the host reports in
``/proc/sys/net/ipv4/ip_local_port_range``, so no outgoing connection is
ever given one of them.  That range differs between hosts: Linux's default
is 32768–60999, gVisor's 16000–65535.
"""

from __future__ import annotations

import random
import socket
from pathlib import Path
from typing import Iterable, Tuple

#: Where the host states its ephemeral range.
EPHEMERAL_RANGE_FILE = Path("/proc/sys/net/ipv4/ip_local_port_range")
#: Linux's default ``net.ipv4.ip_local_port_range``, taken where the file
#: cannot be read.
DEFAULT_EPHEMERAL = (32768, 60999)
#: The lowest port handed out: above the ports of well-known services.
PORT_FLOOR = 10000
#: The fewest ports a range outside the ephemeral one must hold.
MIN_PORTS = 1024


def ephemeral_range(path: Path = EPHEMERAL_RANGE_FILE) -> Tuple[int, int]:
    """The host's ephemeral ports, both ends included."""
    try:
        lo, hi = (int(v) for v in path.read_text().split()[:2])
    except (OSError, ValueError):
        return DEFAULT_EPHEMERAL
    return lo, hi


def port_range(ephemeral: Tuple[int, int]) -> Tuple[int, int]:
    """The half-open range :func:`listen_port` draws from: below the
    ephemeral range, from :data:`PORT_FLOOR`, or else above it."""
    lo, hi = ephemeral
    if lo - PORT_FLOOR >= MIN_PORTS:
        return PORT_FLOOR, lo
    if 65535 - hi >= MIN_PORTS:
        return hi + 1, 65536
    raise RuntimeError(f"no {MIN_PORTS} ports outside the ephemeral range {lo}-{hi}")


#: Half-open range the ports are drawn from on this host.
PORT_RANGE = port_range(ephemeral_range())


def listen_port(host: str = "127.0.0.1", exclude: Iterable[int] = ()) -> int:
    """A port on ``host`` that binds now and lies in :data:`PORT_RANGE`.

    ``exclude`` holds ports already handed out but not yet bound (a fleet
    picks all its replicas' ports before it starts any of them)."""
    taken = set(exclude)
    rng = random.SystemRandom()
    for _ in range(512):
        port = rng.randrange(*PORT_RANGE)
        if port in taken:
            continue
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port on {host} in {PORT_RANGE}")
