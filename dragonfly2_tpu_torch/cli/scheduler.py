"""scheduler service binary (reference: cmd/scheduler + scheduler/scheduler.go).

``build`` wires the scheduler composition: resource managers, the
columnar host store, the evaluator for the configured algorithm (``nt``
over the probe store when ``network_topology.enable`` is set, ``ml`` with
cross-request scorer micro-batching), the scheduling engine, record
storage and the network-topology probe store.  With a scorer blob it
installs the fused gather+score scorer on ``device``, the way a model
subscription would.

``serve`` is the binary's serve mode as a composition that returns a
handle (``.url``, ``.stop()``): ``SchedulerHTTPServer`` over ``build``,
the GC runner, the probe graph reloaded from and saved to
``storage.dir/topology_state.json``, and with ``manager_addr`` the
registration (``RemoteClusterClient``), ``TopologySync`` and, for
``ml``, a ``ModelSubscriber`` over ``RemoteRegistry`` and
``RolloutRESTClient`` that shadow-scores ``scheduling.shadow_sample_rate``
of the announces into ``storage.dir/shadow_replay.dfc``, with a
``RolloutReporter`` reporting every
``scheduling.rollout_report_interval_s``; with ``trainer.enable`` and
``trainer.addr``, the ``Announcer`` uploads the record shards every
``trainer.interval_s``.  Two things the reference
starts with a manager are not started here: the remote job worker and
dynconfig (ROADMAP queue 1 item 14); serve mode says so at boot.

``run(argv)`` is the binary.  ``--simulate N`` runs an N-download
synthetic swarm into the configured record storage and prints the
reference's line of record counts.  Without it the binary serves until
SIGINT or SIGTERM, then stops what it started in the reference's order
and exits 0.  A gRPC port (``server.grpc_port >= 0``) or a ``grpc://``
trainer address exits 2 naming ROADMAP queue 1 item 12c; a config key
whose reader is not ported exits 2 naming its item.  The seed-peer
trigger waits for ROADMAP queue 1 item 10.

    DRAGONFLY_SCHEDULER_STORAGE_DIR=DIR \\
        python -m dragonfly2_tpu_torch.cli.scheduler [--simulate N] [--device cpu]
"""

from __future__ import annotations

import os
import random
import socket
import sys
from dataclasses import dataclass
from typing import Optional

from ..config import ConfigError, SchedulerConfigFile, load_config  # noqa: F401
from ..ops._build import resolve_device
from ..ops.fused_score import FusedMLPScorer
from ..records.storage import Storage
from ..scheduler import (
    HostFeatureCache,
    NetworkTopology,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
    ScorerBatcher,
    TopologyConfig,
    new_evaluator,
)
from ..trainer.export import load_scorer
from ..utils import gc as dfgc
from .common import base_parser, init_debug, init_logging, wait_for_signal

# The name the serving slice gave the scheduler's config.
SchedulerConfig = SchedulerConfigFile


def build(
    cfg: Optional[SchedulerConfigFile] = None,
    *,
    device="cuda",
    scorer_blob: Optional[bytes] = None,
    rng: Optional[random.Random] = None,
) -> SchedulerService:
    """Composition root (scheduler.go:69-301 New).

    ``device`` is where a fused scorer serves (``"cuda"`` unless the
    caller asks for the CPU; no CUDA device raises).  ``scorer_blob`` is
    an exported scorer artifact (``trainer.export.scorer_to_bytes``) for
    the ``ml`` algorithm.  ``rng`` drives candidate sampling and the probe
    store's choice of probe targets (one generator for both, as the
    reference's process-global ``random``).  The service carries
    ``.storage`` and ``.networktopology`` (None when
    ``network_topology.enable`` is off)."""
    cfg = cfg or SchedulerConfigFile()
    cfg.validate()
    device = resolve_device(device)
    rng = rng if rng is not None else random.Random()
    sc = cfg.scheduling
    resource = Resource(
        host_ttl=cfg.gc.host_ttl_s,
        task_ttl=cfg.gc.task_ttl_s,
        peer_ttl=cfg.gc.peer_ttl_s,
    )
    topology = None
    if cfg.network_topology.enable:
        topology = NetworkTopology(
            resource.host_manager,
            TopologyConfig(
                probe_queue_length=cfg.network_topology.probe_queue_length,
                probe_count=cfg.network_topology.probe_count,
                collect_interval=cfg.network_topology.collect_interval_s,
            ),
            rng=rng,
        )
    # Every algorithm gets the columnar host store (DESIGN.md §18); only
    # ml additionally gets cross-request scorer micro-batching.
    feature_cache = HostFeatureCache(max_hosts=sc.eval_feature_cache_hosts)
    batcher = None
    if sc.algorithm == "ml":
        batcher = ScorerBatcher(linger_s=sc.eval_batch_linger_ms / 1e3)
    evaluator = new_evaluator(
        sc.algorithm, networktopology=topology, feature_cache=feature_cache,
        batcher=batcher,
    )
    if scorer_blob is not None:
        if sc.algorithm != "ml":
            raise ConfigError("a scorer blob needs scheduling.algorithm 'ml'")
        evaluator.set_scorer(
            FusedMLPScorer.from_scorer(
                feature_cache, load_scorer(scorer_blob), device=device
            )
        )
    scheduling = Scheduling(
        evaluator,
        SchedulingConfig(
            candidate_parent_limit=sc.candidate_parent_limit,
            filter_parent_limit=sc.filter_parent_limit,
            retry_limit=sc.retry_limit,
            retry_back_to_source_limit=sc.retry_back_to_source_limit,
            retry_interval=sc.retry_interval_s,
        ),
        rng=rng,
    )
    storage = Storage(
        cfg.storage.dir,
        buffer_size=cfg.storage.buffer_size,
        max_size=cfg.storage.max_size,
        max_backups=cfg.storage.max_backups,
    )
    return SchedulerService(resource, scheduling, storage, topology)


@dataclass
class SchedulerServing:
    """What ``serve`` started; ``stop()`` stops it in the reference's
    order (cli/scheduler.py:577-601) and then the GC runner."""

    service: SchedulerService
    rpc_server: object
    runner: dfgc.GC
    scheduler_id: str
    topology_state_path: Optional[str] = None
    cluster_link: object = None
    topology_sync: object = None
    model_subscriber: object = None
    rollout_reporter: object = None
    announcer: object = None

    @property
    def url(self) -> str:
        return self.rpc_server.url

    def stop(self) -> None:
        self.rpc_server.stop()
        if self.announcer is not None:
            self.announcer.stop()
        if self.cluster_link is not None:
            self.cluster_link.stop()
        if self.rollout_reporter is not None:
            self.rollout_reporter.stop()
        if self.model_subscriber is not None:
            self.model_subscriber.stop()
        if self.topology_sync is not None:
            self.topology_sync.stop()  # final disk checkpoint
        elif self.topology_state_path is not None:
            self.service.networktopology.save(self.topology_state_path)
        self.runner.stop()


def serve(
    cfg: Optional[SchedulerConfigFile] = None,
    *,
    device="cuda",
    scorer_blob: Optional[bytes] = None,
    rng: Optional[random.Random] = None,
) -> SchedulerServing:
    """The binary's serve mode (reference cli/scheduler.py:167-575) as a
    composition: ``build(cfg, device=, scorer_blob=, rng=)`` behind
    ``SchedulerHTTPServer`` on ``server.host:server.port`` (0 binds an
    ephemeral port), with the GC runner, the probe-graph checkpoint, the
    manager link and the trainer link the config asks for.  A
    ``scorer_blob`` installs K1's fused scorer, so announces arriving
    over HTTP are ranked by K1 until a subscription installs what
    ``load_scorer`` returns.  Raises ``ConfigError`` for what is not
    ported (a gRPC port, a ``grpc://`` trainer)."""
    cfg = cfg or SchedulerConfigFile()
    cfg.validate()
    if cfg.server.grpc_port >= 0:
        raise ConfigError(
            "server.grpc_port >= 0 asks for the gRPC transport, "
            "which is not ported yet (ROADMAP queue 1 item 12c)"
        )
    trainer_link = cfg.trainer.enable and cfg.trainer.addr
    if trainer_link and cfg.trainer.addr.startswith("grpc://"):
        raise ConfigError(
            "a grpc:// trainer.addr needs the gRPC transport, "
            "which is not ported yet (ROADMAP queue 1 item 12c)"
        )
    from ..rpc import RemoteTrainer, SchedulerHTTPServer
    from ..rpc.ratelimit import maybe_bucket

    service = build(cfg, device=device, scorer_blob=scorer_blob, rng=rng)
    resource = service.resource
    runner = dfgc.GC()
    runner.add(
        dfgc.Task(
            "resource",
            interval=cfg.gc.interval_s,
            timeout=cfg.gc.interval_s / 2,
            runner=lambda: resource.run_gc(),
        )
    )
    # Durable probe graph (the Redis-persistence analog): reload the
    # saved state at boot so the nt evaluator keeps its RTT scores across
    # restarts; TopologySync (below) re-saves every interval + on stop.
    topology_state_path = None
    if service.networktopology is not None:
        # The port's record storage makes its directory at the first
        # flush; the probe-graph checkpoint may come first.
        os.makedirs(cfg.storage.dir, exist_ok=True)
        topology_state_path = os.path.join(cfg.storage.dir, "topology_state.json")
        loaded = service.networktopology.load(topology_state_path)
        if loaded:
            print(f"scheduler: reloaded {loaded} probe edges", flush=True)
        # Periodic checkpoint when no manager is configured — a kill must
        # cost at most one interval of probes.  With a manager, the
        # TopologySync loop owns the checkpointing (ONE writer; two
        # unsynchronized savers would race on the state file).
        if not cfg.manager_addr:
            runner.add(
                dfgc.Task(
                    "topology-save", interval=60.0, timeout=30.0,
                    runner=lambda: service.networktopology.save(topology_state_path),
                )
            )
    runner.start()
    bucket = maybe_bucket(cfg.server.rate_limit_qps, cfg.server.rate_limit_burst)
    rpc_server = SchedulerHTTPServer(
        service, host=cfg.server.host, port=cfg.server.port, rate_limit=bucket
    )
    rpc_server.serve()
    # ONE identity for registration and the announcer's keepalive tick;
    # the serving port joins the id so replicas on one host stay
    # distinct in the manager's cluster table.
    scheduler_id = f"sched-{socket.gethostname()}-{rpc_server.address[1]}"
    serving = SchedulerServing(
        service=service, rpc_server=rpc_server, runner=runner,
        scheduler_id=scheduler_id, topology_state_path=topology_state_path,
    )
    if cfg.manager_addr:
        from ..rpc.cluster_client import RemoteClusterClient
        from ..rpc.registry_client import RemoteRegistry
        from ..rpc.resolver import ManagerEndpoints

        token = cfg.manager_token or None
        # ONE shared multi-endpoint resolver for every manager-facing
        # client in this process (manager_addr accepts a comma-separated
        # replica list).
        manager_endpoints = ManagerEndpoints(cfg.manager_addr, client="scheduler")
        # Register the BOUND port (port: 0 configs bind an ephemeral
        # one).  A failed first registration only warns; the keepalive
        # loop re-registers.
        serving.cluster_link = RemoteClusterClient(manager_endpoints, token=token)
        serving.cluster_link.register_scheduler(
            id=scheduler_id, cluster_id=cfg.cluster_id,
            hostname=socket.gethostname(), ip=cfg.server.host,
            port=rpc_server.address[1],
        )
        print(
            "scheduler: with a manager the reference also starts the remote job "
            "worker and dynconfig; neither is ported (ROADMAP queue 1 item 14)",
            flush=True,
        )
        # Cross-replica topology sharing through the manager (the Redis
        # analog): probes landed on OTHER schedulers inform this one's nt
        # evaluator, and each sync checkpoints the local graph to disk.
        if service.networktopology is not None:
            from ..scheduler.topology_sync import TopologySync

            serving.topology_sync = TopologySync(
                service.networktopology, manager_endpoints, scheduler_id,
                token=token, interval_s=cfg.topology_sync_interval_s,
                state_path=topology_state_path,
            )
            serving.topology_sync.serve()
        # Model rollout plane (DESIGN.md §15): the ml evaluator polls the
        # manager registry for the active AND candidate versions (seeded
        # ±jitter so a fleet never herds the registry), shadow-scores a
        # sampled announce slice into a replay log, and reports joined
        # outcome quality back to the rollout controller.
        if cfg.scheduling.algorithm == "ml":
            from ..rollout import RolloutReporter, RolloutRESTClient
            from ..scheduler import ModelSubscriber

            # The shadow log opens in storage.dir when a candidate
            # attaches, maybe before record storage's first flush.
            os.makedirs(cfg.storage.dir, exist_ok=True)
            serving.model_subscriber = ModelSubscriber(
                RemoteRegistry(manager_endpoints, token=token),
                service.scheduling.evaluator,
                scheduler_id=scheduler_id,
                idc=cfg.scheduling.idc or None,
                refresh_interval=cfg.scheduling.model_poll_interval_s,
                jitter=cfg.scheduling.model_poll_jitter,
                rollout_client=RolloutRESTClient(manager_endpoints, token=token),
                shadow_sample_rate=cfg.scheduling.shadow_sample_rate,
                shadow_log_path=os.path.join(cfg.storage.dir, "shadow_replay.dfc"),
            )
            serving.model_subscriber.serve()
            serving.rollout_reporter = RolloutReporter(
                serving.model_subscriber, service.storage,
                RolloutRESTClient(manager_endpoints, token=token),
                interval_s=cfg.scheduling.rollout_report_interval_s,
            )
            serving.rollout_reporter.serve()
    # Periodic dataset upload to the trainer (announcer.go:127-142 train
    # ticker, default 7d) — the link that feeds the learning loop.
    if trainer_link:
        from ..scheduler.announcer import Announcer

        serving.announcer = Announcer(
            scheduler_id=scheduler_id,
            storage=service.storage,
            trainer=RemoteTrainer(cfg.trainer.addr),
            # The Announcer's own loop drives manager liveness over the
            # REST wire when both links are configured (one loop, not
            # two).
            cluster_manager=serving.cluster_link,
            cluster_id=cfg.cluster_id,
            ip=cfg.server.host,
            port=rpc_server.address[1],
            hostname=socket.gethostname(),
            train_interval=cfg.trainer.interval_s,
        )
        serving.announcer.serve()
    elif serving.cluster_link is not None:
        # No Announcer to tick liveness → the client's own thin loop.
        serving.cluster_link.serve()
    print(
        f"scheduler: serving rpc on {rpc_server.url}"
        + (f", dataset uploads to {cfg.trainer.addr} every "
           f"{cfg.trainer.interval_s:.0f}s" if serving.announcer else "")
        + " (ctrl-c to stop)",
        flush=True,
    )
    return serving


def run(argv=None) -> int:
    """The binary's body; → exit code."""
    p = base_parser("scheduler", "Parent-peer scheduling service")
    p.add_argument("--simulate", type=int, default=0, metavar="N",
                   help="run an N-download synthetic swarm and exit")
    p.add_argument("--device", default="cuda",
                   help="torch device a fused scorer serves on (cuda or cpu)")
    args = p.parse_args(argv)
    init_logging(args, "scheduler")
    debug = init_debug(args)
    try:
        try:
            cfg = load_config(SchedulerConfigFile, args.config)
            if not args.simulate:
                serving = serve(cfg, device=args.device)
        except ConfigError as exc:
            print(f"scheduler: {exc}", file=sys.stderr)
            return 2
        if not args.simulate:
            wait_for_signal()
            serving.stop()
            return 0
        rng = random.Random()
        service = build(cfg, device=args.device, rng=rng)
        storage = service.storage
        # Durable probe graph (the Redis-persistence analog): reload the
        # saved state at boot so the nt evaluator keeps its RTT scores
        # across restarts.
        if service.networktopology is not None:
            loaded = service.networktopology.load(
                os.path.join(cfg.storage.dir, "topology_state.json")
            )
            if loaded:
                print(f"scheduler: reloaded {loaded} probe edges", flush=True)

        from ..sim import SwarmConfig, SwarmSimulator

        sim = SwarmSimulator(storage, config=SwarmConfig(num_hosts=32, seed=0), rng=rng)
        done = sim.run_downloads(args.simulate)
        sim.run_probe_rounds(1)
        n_topo = sim.snapshot_topology()
        storage.flush()
        print(
            f"scheduler: simulated {done} downloads -> "
            f"{storage.download_count} download records, "
            f"{storage.network_topology_count} topology records ({n_topo} snapshots)"
        )
        return 0
    finally:
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
