"""``utils/ports.listen_port``: the ports the drills spawn listeners on lie
outside the host's ephemeral range, so a killed replica's port cannot be
taken by an outgoing connection before the replica's restart binds it
again."""

import socket
from pathlib import Path

import pytest

from dist_svgd_torch.utils import ports

_EPHEMERAL = Path("/proc/sys/net/ipv4/ip_local_port_range")


@pytest.mark.parametrize("draw", range(8))
def test_port_binds_and_lies_in_range(draw):
    port = ports.listen_port()
    lo, hi = ports.PORT_RANGE
    assert lo <= port < hi
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def test_range_lies_below_the_ephemeral_range():
    if not _EPHEMERAL.exists():
        pytest.skip("no Linux ephemeral port range to read")
    low = int(_EPHEMERAL.read_text().split()[0])
    assert ports.PORT_RANGE[1] <= low


@pytest.mark.parametrize("ephemeral, expected", [
    ((32768, 60999), (10000, 32768)),  # Linux's default
    ((16000, 65535), (10000, 16000)),  # gVisor's
    ((1024, 60999), (61000, 65536)),   # nothing below: above it
    ((11000, 64000), (64001, 65536)),  # too little below: above it
])
def test_range_lies_outside_the_ephemeral_range(ephemeral, expected):
    lo, hi = ports.port_range(ephemeral)
    assert (lo, hi) == expected
    assert hi - lo >= ports.MIN_PORTS
    assert hi <= ephemeral[0] or lo > ephemeral[1]


def test_no_room_outside_the_ephemeral_range_raises():
    with pytest.raises(RuntimeError, match="outside the ephemeral range"):
        ports.port_range((1024, 65535))


@pytest.mark.parametrize("text, expected", [
    ("16000\t65535\n", (16000, 65535)),
    ("32768 60999", (32768, 60999)),
    ("garbled", ports.DEFAULT_EPHEMERAL),
    (None, ports.DEFAULT_EPHEMERAL),  # no file
])
def test_ephemeral_range_is_read_from_the_host(tmp_path, text, expected):
    path = tmp_path / "ip_local_port_range"
    if text is not None:
        path.write_text(text)
    assert ports.ephemeral_range(path) == expected


def test_excluded_and_bound_ports_are_skipped(monkeypatch):
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        busy = held.getsockname()[1]
        held.listen()
        draws = iter([busy, 25001, 25002])

        class _Draws:
            def randrange(self, lo, hi):
                return next(draws)

        monkeypatch.setattr(ports.random, "SystemRandom", _Draws)
        # the held port fails to bind, 25001 is excluded: 25002 comes back
        assert ports.listen_port(exclude=[25001]) == 25002


def test_raises_when_nothing_binds(monkeypatch):
    class _Same:
        def randrange(self, lo, hi):
            return 25000

    monkeypatch.setattr(ports.random, "SystemRandom", _Same)
    with pytest.raises(RuntimeError, match="no free port"):
        ports.listen_port(exclude=[25000])


def test_a_client_socket_on_a_port_blocks_a_listener():
    """The fault the range avoids: an open client socket on a port makes a
    listener's bind there fail, even with SO_REUSEADDR set."""
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen()
        with socket.create_connection(srv.getsockname()) as cli:
            taken = cli.getsockname()[1]
            with socket.socket() as again:
                again.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                with pytest.raises(OSError):
                    again.bind(("127.0.0.1", taken))
