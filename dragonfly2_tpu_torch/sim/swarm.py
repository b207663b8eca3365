"""Swarm simulator: synthetic peers exercising the real scheduler stack.

Each simulated download follows the reference's v1 flow (SURVEY §3.1):
register → schedule → per-piece downloads from assigned parents (piece
cost = piece size / ground-truth bandwidth) → ReportPeerResult → Download
record in storage.  Probe rounds follow §3.3: agents ping ground-truth
RTTs into the topology store; snapshots land in storage.

Because piece costs come from SyntheticCluster's latent bandwidth model,
the records are *learnable* and evaluator quality is *measurable*: rank
parents for a fresh child and compare achieved ground-truth bandwidth.

Port of ``dragonfly2_tpu/sim/swarm.py``, logic verbatim.  The numpy draws
(child, task, piece counts, the quality trials) come from ``self.rng`` as
in the reference; candidate sampling and probe-target choice, which the
reference draws from the process-global ``random``, come from one
``random.Random`` (``SwarmSimulator(rng=...)``) shared by the scheduling
engine and the probe store, so the two packages seeded alike schedule
alike.  ``host_from_latent`` turns a latent host into the scheduler Host
an announce would build; ``build_announce_swarm`` is the serving-path
fixture.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..records.storage import Storage
from ..records.synthetic import PIECE_SIZE, SyntheticCluster
from ..scheduler import (
    Evaluator,
    NetworkTopology,
    ProbeAgent,
    Resource,
    ScheduleResultKind,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
)
from ..scheduler.resource import Host, Peer, Task
from ..utils.types import HostType


@dataclass
class SwarmConfig:
    num_hosts: int = 48
    seed: int = 0
    pieces_per_download: int = 8
    candidate_parent_limit: int = 4


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


class SwarmSimulator:
    def __init__(
        self,
        storage: Storage,
        *,
        config: Optional[SwarmConfig] = None,
        evaluator: Optional[Evaluator] = None,
        cluster: Optional[SyntheticCluster] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        """``rng`` drives candidate sampling and probe-target choice (a
        fresh unseeded generator when None)."""
        self.config = config or SwarmConfig()
        self.cluster = cluster or SyntheticCluster(
            num_hosts=self.config.num_hosts, seed=self.config.seed
        )
        self.rng = np.random.default_rng(self.config.seed)
        sched_rng = rng if rng is not None else random.Random()
        self.resource = Resource()
        self.topology = NetworkTopology(self.resource.host_manager, rng=sched_rng)
        self.scheduling = Scheduling(
            evaluator or Evaluator(),
            SchedulingConfig(
                retry_interval=0,
                candidate_parent_limit=self.config.candidate_parent_limit,
            ),
            rng=sched_rng,
        )
        self.service = SchedulerService(
            self.resource, self.scheduling, storage, self.topology
        )
        self.storage = storage
        self.hosts: List[Host] = [self._register_host(i) for i in range(self.cluster.num_hosts)]
        self._host_index: Dict[str, int] = {h.id: i for i, h in enumerate(self.hosts)}

    def _register_host(self, i: int) -> Host:
        h = host_from_latent(self.cluster.hosts[i])
        self.resource.store_host(h)
        return h

    # -- download simulation -------------------------------------------------

    def simulate_download(
        self, child_idx: Optional[int] = None, url: Optional[str] = None
    ) -> Optional[Peer]:
        """One full download; returns the child peer (None if unschedulable)."""
        r = self.rng
        child_idx = int(r.integers(0, len(self.hosts))) if child_idx is None else child_idx
        child_host = self.hosts[child_idx]
        url = url or f"https://origin.example.com/blob/{int(r.integers(0, 1 << 16))}"

        result = self.service.register_peer(host=child_host, url=url)
        peer = result.peer
        task = peer.task
        if task.content_length < 0:
            # First peer learns the content length from the origin; sizes
            # vary per task so the training corpus spans content lengths.
            pieces = int(r.integers(2, 2 * self.config.pieces_per_download + 1))
            task.content_length = pieces * PIECE_SIZE
            task.total_piece_count = pieces
            task.piece_size = PIECE_SIZE

        if result.schedule is None or result.schedule.kind is not ScheduleResultKind.PARENTS:
            # Back-to-source: origin serves at the child's download capacity.
            bw = float(self.cluster.down_cap[child_idx]) * 0.5
            for n in range(task.total_piece_count):
                cost = int(PIECE_SIZE / bw * 1e9)
                self.service.report_piece_finished(
                    peer, n, parent_id="", length=PIECE_SIZE, cost_ns=cost
                )
            self.service.report_peer_finished(peer)
            return peer

        parents = result.schedule.parents
        # Pieces round-robin over assigned parents with ground-truth costs.
        for n in range(task.total_piece_count):
            parent = parents[n % len(parents)]
            p_idx = self._host_index[parent.host.id]
            bw = self.cluster.bandwidth(p_idx, child_idx)
            cost = int(PIECE_SIZE / max(bw, 1e3) * 1e9)
            self.service.report_piece_finished(
                peer, n, parent_id=parent.id, length=PIECE_SIZE, cost_ns=cost
            )
        self.service.report_peer_finished(peer)
        return peer

    def seed_task(self, url: str, n_seeds: int = 4) -> None:
        """Bootstrap a task: n hosts fetch from origin (become parents)."""
        for _ in range(n_seeds):
            self.simulate_download(
                child_idx=int(self.rng.integers(0, len(self.hosts))), url=url
            )

    def run_downloads(self, n: int, *, tasks: int = 8) -> int:
        """Simulate a workload over a small task catalog; returns records written."""
        urls = [f"https://origin.example.com/blob/{t}" for t in range(tasks)]
        for url in urls:
            self.seed_task(url, n_seeds=2)
        done = 0
        for _ in range(n):
            url = urls[int(self.rng.integers(0, len(urls)))]
            if self.simulate_download(url=url) is not None:
                done += 1
        return done

    # -- probe simulation (§3.3) ---------------------------------------------

    def run_probe_rounds(self, rounds: int = 3) -> None:
        # Agents built once: reconstructing num_hosts ProbeAgents (and
        # their ping closures) per round was pure allocation churn.
        if not hasattr(self, "_probe_agents"):
            self._probe_agents = [
                ProbeAgent(
                    host,
                    self.topology,
                    ping=lambda target, i=i: int(
                        self.cluster.rtt_ns(i, self._host_index[target.id])
                    ),
                )
                for i, host in enumerate(self.hosts)
            ]
        for _ in range(rounds):
            for agent in self._probe_agents:
                agent.sync_probes()

    def snapshot_topology(self) -> int:
        records = self.topology.snapshot()
        for rec in records:
            self.storage.create_network_topology(rec)
        return len(records)

    # -- evaluator quality measurement ---------------------------------------

    def measure_parent_choice_quality(
        self, evaluator: Evaluator, n_trials: int = 50, seed: int = 1234
    ) -> float:
        """Mean ground-truth bandwidth (MB/s) of the evaluator's top-ranked
        parent over fresh (child, candidate-set) draws.  Higher is better;
        the ML-vs-rules comparison metric (BASELINE configs[2] 'beats
        rule-based evaluator')."""
        r = np.random.default_rng(seed)
        total = 0.0
        trials = 0
        # A dedicated task swarm with every host as a potential parent.
        url = "https://origin.example.com/eval-blob"
        reg = self.service.register_peer(host=self.hosts[0], url=url)
        task = reg.peer.task
        if task.content_length < 0:
            task.content_length = 16 * PIECE_SIZE
            task.total_piece_count = 16
            task.piece_size = PIECE_SIZE
        candidates: List[Peer] = []
        for i in range(1, len(self.hosts)):
            res = self.service.register_peer(host=self.hosts[i], url=url)
            p = res.peer
            for n in range(4):
                p.finish_piece(n, int(PIECE_SIZE / 50e6 * 1e9), length=PIECE_SIZE)
            if p.fsm.can("DownloadSucceeded"):
                p.fsm.event("DownloadSucceeded")
            candidates.append(p)
        # Host-index → candidate position, computed ONCE: the per-trial
        # linear scans (`next(c for c in candidates ...)` + a filtered
        # rebuild of the pool) made every trial O(n_hosts).
        cand_host_idx = np.fromiter(
            (self._host_index[c.host.id] for c in candidates),
            dtype=np.int64,
            count=len(candidates),
        )
        peer_by_host_idx = {
            int(idx): c for idx, c in zip(cand_host_idx, candidates)
        }
        for _ in range(n_trials):
            child_i = int(r.integers(0, len(self.hosts)))
            child_peer = peer_by_host_idx.get(child_i)
            pool_positions = np.flatnonzero(cand_host_idx != child_i)
            pool = r.choice(
                pool_positions,
                size=min(8, len(pool_positions)),
                replace=False,
            )
            subset = [candidates[int(j)] for j in pool]
            probe_child = child_peer or reg.peer
            ranked = evaluator.evaluate_parents(subset, probe_child, task.total_piece_count)
            top_idx = self._host_index[ranked[0].host.id]
            total += self.cluster.bandwidth(top_idx, child_i, noise=False)
            trials += 1
        return total / trials / 1e6
