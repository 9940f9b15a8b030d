"""Listening ports for the local processes the port's drills spawn.

A port found by binding to port 0 comes from the kernel's ephemeral range,
the same range that outgoing connections take their local ports from.  A
replica that is killed and restarted on its old port can then find the port
held by one of the router's own client sockets (open, or in TIME_WAIT for a
minute after its close) and fail to bind with ``EADDRINUSE``.  The ports
handed out here lie below Linux's default ephemeral range (which starts at
32768), so no outgoing connection is ever given one of them.
"""

from __future__ import annotations

import random
import socket
from typing import Iterable

#: Half-open range the ports are drawn from: below Linux's default
#: ``net.ipv4.ip_local_port_range`` (32768–60999).
PORT_RANGE = (20000, 32768)


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
