"""Swarm fixtures: synthetic peers for the real scheduler stack.

``host_from_latent`` turns a SyntheticCluster latent host into the
scheduler Host an announce would build; ``build_announce_swarm`` is the
serving-path fixture.  The download simulator (``SwarmSimulator``) needs
record storage and the probe store and waits for them.
"""

from __future__ import annotations

import numpy as np

from ..records.synthetic import PIECE_SIZE, SyntheticCluster
from ..scheduler.resource import Host, Peer, Task
from ..utils.types import HostType


def host_from_latent(lh) -> Host:
    """SyntheticCluster latent host → scheduler Host (stats populated the
    way announce would)."""
    h = Host(
        id=lh.id,
        hostname=lh.hostname,
        ip=lh.ip,
        port=8002,
        download_port=8001,
        type=HostType.SUPER_SEED if lh.type == "super" else HostType.NORMAL,
        concurrent_upload_limit=lh.upload_limit,
    )
    h.stats.network.idc = lh.idc_name
    h.stats.network.location = lh.location
    h.stats.cpu.percent = lh.cpu_load * 100.0
    h.stats.memory.used_percent = lh.mem_load * 100.0
    h.stats.disk.used_percent = lh.disk_load * 100.0
    h.stats.network.tcp_connection_count = lh.tcp_conns
    h.stats.network.upload_tcp_connection_count = lh.upload_conns
    h.upload_count = lh.upload_count
    h.upload_failed_count = lh.upload_failed
    h.concurrent_upload_count = lh.concurrent_uploads
    return h


def build_announce_swarm(
    num_hosts: int = 1000,
    *,
    seed: int = 0,
    total_piece_count: int = 16,
    max_finished: int = 12,
    served_parents: int = 6,
):
    """Serving-path fixture: ONE task with a Running peer per synthetic
    host, piece costs and parent-attributed child pieces populated, ready
    for ``evaluate_parents`` announce workloads (tools/bench_sched.py and
    the vectorized-vs-scalar property tests).  Returns (task, peers).
    """
    cluster = SyntheticCluster(num_hosts=num_hosts, seed=seed)
    rng = np.random.default_rng(seed)
    task = Task("announce-bench-task", "https://origin.example.com/bench-blob")
    task.content_length = total_piece_count * PIECE_SIZE
    task.total_piece_count = total_piece_count
    task.piece_size = PIECE_SIZE
    peers = []
    for i in range(num_hosts):
        host = host_from_latent(cluster.hosts[i])
        peer = Peer(f"bench-peer-{i}", task, host)
        task.store_peer(peer)
        host.store_peer(peer)
        peer.fsm.event("RegisterNormal")
        peer.fsm.event("Download")
        peer.cost_ns = int(rng.integers(0, 10**10))
        peers.append(peer)
    for i, peer in enumerate(peers):
        n_done = int(rng.integers(0, max_finished + 1))
        # Pieces attributed to a few nearby parents, realistic costs, so
        # featurization's served-piece grouping has real work to do.
        donors = rng.integers(0, num_hosts, size=served_parents)
        for n in range(n_done):
            donor = peers[int(donors[n % served_parents])]
            peer.finish_piece(
                n,
                int(rng.integers(10**6, 10**9)),
                parent_id=donor.id,
                length=PIECE_SIZE,
            )
    return task, peers
