"""RTT probing (reference: pkg/net/ping — the ICMP prober behind the
daemon's probe agent).

``icmp_ping`` is real ICMP echo (pkg/net/ping semantics): it tries the
unprivileged datagram-ICMP socket first (Linux ``ping_group_range``),
then a raw socket (CAP_NET_RAW), building/parsing echo packets directly.

``tcp_ping`` is the deliberate fallback divergence: where ICMP is
unavailable (no capability, containers with ping groups closed), the RTT
of a SYN/accept round against the target's announced download port
stands in.  Note the measured quantity differs from ICMP — a loaded
accept queue inflates "RTT" with server load — which is arguably useful
for parent selection (a busy server IS slower to serve) but is not the
reference's network-distance semantics; deployments wanting pure ICMP
grant the capability and get it automatically.

``make_host_pinger`` composes both behind the ProbeAgent's pluggable
callable: ICMP when the socket is obtainable, TCP otherwise.

Port of ``dragonfly2_tpu/utils/ping.py``, verbatim.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional


def _icmp_checksum(data: bytes) -> int:
    if len(data) % 2:
        data += b"\x00"
    total = sum(struct.unpack(f"!{len(data) // 2}H", data))
    total = (total >> 16) + (total & 0xFFFF)
    total += total >> 16
    return ~total & 0xFFFF


def _open_icmp_socket() -> Optional[socket.socket]:
    """Unprivileged datagram ICMP first, raw second; None when neither is
    permitted."""
    for sock_type in (socket.SOCK_DGRAM, socket.SOCK_RAW):
        try:
            return socket.socket(socket.AF_INET, sock_type, socket.IPPROTO_ICMP)
        except (PermissionError, OSError):
            continue
    return None


def icmp_available() -> bool:
    s = _open_icmp_socket()
    if s is None:
        return False
    s.close()
    return True


def icmp_ping(ip: str, *, timeout: float = 1.0, seq: int = 0) -> Optional[int]:
    """RTT in nanoseconds of one ICMP echo, or None on timeout/denial.

    Echo request: type 8, code 0, identifier from the pid, 16-byte
    payload carrying the send timestamp.  The reply is matched on the
    payload (datagram-ICMP sockets rewrite the identifier; raw sockets
    deliver the IP header too — both shapes handled).
    """
    s = _open_icmp_socket()
    if s is None:
        return None
    try:
        s.settimeout(timeout)
        ident = os.getpid() & 0xFFFF
        payload = struct.pack("!Qq", time.monotonic_ns(), seq)
        header = struct.pack("!BBHHH", 8, 0, 0, ident, seq & 0xFFFF)
        checksum = _icmp_checksum(header + payload)
        packet = struct.pack("!BBHHH", 8, 0, checksum, ident, seq & 0xFFFF) + payload
        t0 = time.monotonic_ns()
        s.sendto(packet, (ip, 0))
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            s.settimeout(remaining)
            try:
                data, _addr = s.recvfrom(1024)
            except socket.timeout:
                return None
            t1 = time.monotonic_ns()
            # Raw sockets prepend the IP header; its IHL field gives the
            # offset.  Datagram sockets hand the ICMP message directly.
            if len(data) >= 20 and (data[0] >> 4) == 4 and s.type == socket.SOCK_RAW:
                data = data[(data[0] & 0x0F) * 4:]
            if len(data) < 8 or data[0] != 0:  # echo reply only
                continue
            if data[8:] == payload:
                return t1 - t0
    except OSError:
        return None
    finally:
        s.close()


def tcp_ping(ip: str, port: int, *, timeout: float = 1.0) -> Optional[int]:
    """RTT in nanoseconds of a TCP connect, or None on timeout/refusal.

    1s default timeout matches the reference's ping timeout (the evaluator
    normalizes RTT against it, evaluator_network_topology.go:53-56).
    """
    t0 = time.monotonic_ns()
    try:
        with socket.create_connection((ip, port), timeout=timeout):
            return time.monotonic_ns() - t0
    except OSError:
        return None


def make_host_pinger(*, timeout: float = 1.0, prefer_icmp: bool = True):
    """ProbeAgent-shaped pinger: Host → rtt_ns | None.

    ICMP when the process can open an ICMP socket (checked once),
    else the TCP-connect fallback against the announced download port
    (it is the port peers actually fetch from)."""
    use_icmp = prefer_icmp and icmp_available()
    # Hosts that silently drop ICMP (firewall policy) would otherwise pay
    # the full ICMP timeout before EVERY TCP fallback, forever — memo the
    # first failure per ip and go straight to TCP afterwards.
    icmp_dead: set = set()

    def ping(host) -> Optional[int]:
        if not host.ip:
            return None
        if use_icmp and host.ip not in icmp_dead:
            rtt = icmp_ping(host.ip, timeout=timeout)
            if rtt is not None:
                return rtt
            icmp_dead.add(host.ip)
            # Unreachable by ICMP (filtered) — fall through to TCP.
        port = host.download_port or host.port
        if not port:
            return None
        return tcp_ping(host.ip, port, timeout=timeout)

    return ping
