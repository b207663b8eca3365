"""Networked peer-exchange gossip: the GossipBus seam over UDP.

Reference: client/daemon/pex/ rides hashicorp/memberlist — gossip
membership with metadata broadcast, per-peer piece advertisements,
reclaim-on-leave, and anti-entropy state sync
(peer_exchange.go:34-50, member_manager.go, peer_pool.go).

``NetworkedGossipBus`` is the wire implementation of the same seam the
in-process ``GossipBus`` fills (daemon/pex.py): one bus per daemon
process, one UDP socket, JSON datagrams:

    {"t":"join","meta":{...}}          membership announce (rebroadcast once)
    {"t":"leave","host_id":h}          explicit leave → reclaim
    {"t":"adv","src":h,"task":t,"ranges":[[a,b],...]}   piece advertisement
    {"t":"ret","src":h,"task":t}       retract (eviction)
    {"t":"hb","host_id":h}             heartbeat (failure detection)
    {"t":"sync_req","meta":{...}}      ask for a full state snapshot
    {"t":"sync","members":[...],"holdings":[[h,t,ranges],...]}

Membership is full-mesh (every member keeps every member's address —
fine at swarm sizes where the reference runs memberlist too); liveness
is heartbeat-based: a member silent for ``suspect_after`` intervals is
dropped and its advertisements reclaimed, exactly like memberlist's
leave event.  Anti-entropy: on join a node sync_reqs a seed, and every
``gossip_interval`` it sync_reqs one random member — lost datagrams
converge within one round.

Piece sets travel as sorted [start, end] ranges so a contiguous
holding of any size fits one datagram.

Port of ``dragonfly2_tpu/daemon/pex_net.py``, verbatim.
"""

from __future__ import annotations

import json
import logging
import random
import socket
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .pex import MemberMeta, PeerExchange

logger = logging.getLogger(__name__)

_MAX_DGRAM = 60_000


def pieces_to_ranges(pieces: Set[int]) -> List[List[int]]:
    out: List[List[int]] = []
    for p in sorted(pieces):
        if out and p == out[-1][1] + 1:
            out[-1][1] = p
        else:
            out.append([p, p])
    return out


def ranges_to_pieces(ranges: List[List[int]]) -> Set[int]:
    s: Set[int] = set()
    for a, b in ranges:
        s.update(range(int(a), int(b) + 1))
    return s


class NetworkedGossipBus:
    """UDP gossip transport for exactly one local PeerExchange."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        seeds: Optional[List[Tuple[str, int]]] = None,
        gossip_interval_s: float = 1.0,
        suspect_after: int = 3,
        advertise_ip: str = "",
    ) -> None:
        self.seeds = list(seeds or [])
        self.gossip_interval_s = gossip_interval_s
        self.suspect_after = suspect_after
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self.address: Tuple[str, int] = self._sock.getsockname()
        # The address OTHER nodes dial back: a wildcard bind (0.0.0.0)
        # must never travel in the meta — remote peers would send replies
        # to themselves.
        adv = advertise_ip or self.address[0]
        if adv in ("0.0.0.0", "::"):
            adv = "127.0.0.1"
        self.advertised: Tuple[str, int] = (adv, self.address[1])
        self._mu = threading.Lock()
        self._pex: Optional[PeerExchange] = None
        # host_id → (MemberMeta, gossip_addr, last_seen)
        self._peers: Dict[str, Tuple[MemberMeta, Tuple[str, int], float]] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- GossipBus seam (pex.py PeerExchange calls these) --------------------

    def join(self, pex: PeerExchange) -> None:
        self._pex = pex
        for name, fn in (("pex-recv", self._recv_loop), ("pex-tick", self._tick_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        msg = {"t": "join", "meta": self._meta_wire(pex.meta)}
        for addr in self.seeds:
            self._send(msg, addr)
            self._send({"t": "sync_req", "meta": self._meta_wire(pex.meta)}, addr)

    def leave(self, host_id: str) -> None:
        self._broadcast({"t": "leave", "host_id": host_id})
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def broadcast_advertise(self, src: str, task_id: str, pieces: Set[int]) -> None:
        self._broadcast(
            {"t": "adv", "src": src, "task": task_id,
             "ranges": pieces_to_ranges(pieces)}
        )

    def broadcast_retract(self, src: str, task_id: str) -> None:
        self._broadcast({"t": "ret", "src": src, "task": task_id})

    # -- wire ---------------------------------------------------------------

    def _meta_wire(self, meta: MemberMeta) -> dict:
        return {
            "host_id": meta.host_id, "ip": meta.ip, "port": meta.port,
            "gossip": [self.advertised[0], self.advertised[1]],
        }

    def _send(self, msg: dict, addr: Tuple[str, int]) -> None:
        from ..utils import faultinject

        try:
            faultinject.fire("pex.send")
            data = json.dumps(msg).encode()
            if len(data) > _MAX_DGRAM:
                logger.warning(
                    "pex: dropping %s message of %d bytes (> %d) to %s",
                    msg.get("t"), len(data), _MAX_DGRAM, addr,
                )
                return
            self._sock.sendto(data, tuple(addr))
        except OSError:
            pass  # dflint: disable=DF001 — UDP gossip: drop is the semantics

    def _broadcast(self, msg: dict) -> None:
        with self._mu:
            addrs = [a for _, a, _ in self._peers.values()]
        for addr in addrs:
            self._send(msg, addr)

    def _recv_loop(self) -> None:
        from ..utils import faultinject

        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(_MAX_DGRAM + 4096)
            except OSError:
                return
            try:
                # Drop = datagram lost (skip), truncate = torn datagram
                # that must parse-fail cleanly, never poison the
                # membership table.
                data = faultinject.fire("pex.recv", data)
            except ConnectionError:
                continue
            try:
                msg = json.loads(data)
                self._handle(msg, addr)
            except Exception:  # noqa: BLE001 — malformed gossip must not kill the loop
                logger.debug("pex: bad datagram from %s", addr, exc_info=True)

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.gossip_interval_s):
            if self._pex is None:
                continue
            with self._mu:
                isolated = not self._peers
            if isolated and self.seeds:
                # The one-shot join datagrams may have been lost — keep
                # knocking on the seed list until somebody answers, or the
                # docstring's "converge within one round" is a lie.
                for addr in self.seeds:
                    self._send(
                        {"t": "join", "meta": self._meta_wire(self._pex.meta)},
                        addr,
                    )
                    self._send(
                        {"t": "sync_req",
                         "meta": self._meta_wire(self._pex.meta)},
                        addr,
                    )
                continue
            me = {"t": "hb", "host_id": self._pex.meta.host_id}
            self._broadcast(me)
            # Failure detection: reclaim members we have not heard from.
            cutoff = time.monotonic() - self.gossip_interval_s * self.suspect_after
            with self._mu:
                dead = [h for h, (_, _, seen) in self._peers.items() if seen < cutoff]
                for h in dead:
                    self._peers.pop(h, None)
            for h in dead:
                self._pex._on_leave(h)
            # Anti-entropy: sync with one random member.
            with self._mu:
                addrs = [a for _, a, _ in self._peers.values()]
            if addrs:
                self._send(
                    {"t": "sync_req", "meta": self._meta_wire(self._pex.meta)},
                    random.choice(addrs),
                )

    # -- message handling ----------------------------------------------------

    def _learn(self, meta_wire: dict) -> None:
        pex = self._pex
        if pex is None or meta_wire["host_id"] == pex.meta.host_id:
            return
        meta = MemberMeta(
            host_id=meta_wire["host_id"], ip=meta_wire.get("ip", ""),
            port=int(meta_wire.get("port", 0)),
        )
        gossip_addr = tuple(meta_wire.get("gossip", ("", 0)))
        with self._mu:
            known = meta.host_id in self._peers
            self._peers[meta.host_id] = (meta, gossip_addr, time.monotonic())
        pex._on_join(meta)
        if not known:
            # First contact: introduce ourselves + share our holdings so
            # one-way joins converge without waiting for anti-entropy.
            self._send({"t": "join", "meta": self._meta_wire(pex.meta)}, gossip_addr)
            for task_id, pieces in pex.local_holdings():
                self._send(
                    {"t": "adv", "src": pex.meta.host_id, "task": task_id,
                     "ranges": pieces_to_ranges(pieces)},
                    gossip_addr,
                )

    def _handle(self, msg: dict, addr: Tuple[str, int]) -> None:
        pex = self._pex
        if pex is None:
            return
        kind = msg.get("t")
        if kind == "join":
            self._learn(msg["meta"])
        elif kind == "leave":
            h = msg["host_id"]
            with self._mu:
                self._peers.pop(h, None)
            pex._on_leave(h)
        elif kind == "hb":
            h = msg["host_id"]
            with self._mu:
                entry = self._peers.get(h)
                if entry is not None:
                    self._peers[h] = (entry[0], entry[1], time.monotonic())
        elif kind == "adv":
            if msg["src"] != pex.meta.host_id:
                pex._on_advertise(
                    msg["src"], msg["task"], ranges_to_pieces(msg["ranges"])
                )
        elif kind == "ret":
            if msg["src"] != pex.meta.host_id:
                pex._on_retract(msg["src"], msg["task"])
        elif kind == "sync_req":
            self._learn(msg["meta"])
            dest = tuple(msg["meta"].get("gossip", addr))
            for part in self._snapshot_parts():
                self._send(part, dest)
        elif kind == "sync":
            for meta_wire in msg.get("members", []):
                self._learn(meta_wire)
            for h, task_id, ranges in msg.get("holdings", []):
                if h != pex.meta.host_id:
                    pex._on_advertise(h, task_id, ranges_to_pieces(ranges))

    def _snapshot_parts(self, chunk: int = 200) -> List[dict]:
        """Full-state sync reply, split into datagram-sized messages: a
        big pool must not exceed _MAX_DGRAM and get silently dropped —
        that would disable anti-entropy exactly when it matters."""
        pex = self._pex
        assert pex is not None
        with self._mu:
            members = [self._meta_wire_of(m, a) for m, a, _ in self._peers.values()]
        members.append(self._meta_wire(pex.meta))
        holdings = [
            [pex.meta.host_id, t, pieces_to_ranges(p)]
            for t, p in pex.local_holdings()
        ]
        for h, task_id, pieces in pex.pool_snapshot():
            holdings.append([h, task_id, pieces_to_ranges(pieces)])
        parts: List[dict] = []
        for i in range(0, max(len(members), 1), chunk):
            parts.append({"t": "sync", "members": members[i:i + chunk],
                          "holdings": []})
        for i in range(0, len(holdings), chunk):
            parts.append({"t": "sync", "members": [],
                          "holdings": holdings[i:i + chunk]})
        return parts

    @staticmethod
    def _meta_wire_of(meta: MemberMeta, gossip_addr: Tuple[str, int]) -> dict:
        return {
            "host_id": meta.host_id, "ip": meta.ip, "port": meta.port,
            "gossip": list(gossip_addr),
        }
