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
``storage.dir/topology_state.json``, the shard guard (with admission at
``scheduling.shard_max_inflight`` / ``shard_p99_budget_ms`` and a
``TenantAccounting``, and the SLO autopilot on the metric journal when
``telemetry.slos`` is declared), and with ``manager_addr`` the
registration (``RemoteClusterClient``), ``TopologySync`` and, for
``ml``, a ``ModelSubscriber`` over ``RemoteRegistry`` (its active
models served through K1 where K1 runs them: ``k1_installs``) and
``RolloutRESTClient`` that shadow-scores ``scheduling.shadow_sample_rate``
of the announces into ``storage.dir/shadow_replay.dfc``, with a
``RolloutReporter`` reporting every
``scheduling.rollout_report_interval_s``; with ``trainer.enable`` and
``trainer.addr``, the ``Announcer`` uploads the record shards every
``trainer.interval_s``.  With a manager, serve mode also starts the
remote job worker on queue ``scheduler:<id>`` (the preheat handler warms
each URL through the service's seed trigger, the sync-peers handler dumps
the host manager) and ``Dynconfig``, which polls
``/api/v1/clusters/<cluster_id>:config`` every ``dynconfig_refresh_s``
(cached at ``storage.dir/dynconfig_cache.json``) and applies the
cluster's four scheduling limits, its shard ring (the guard's handoff
sweep on a version bump) and its tenant QoS table live.

``run(argv)`` is the binary.  ``--simulate N`` runs an N-download
synthetic swarm into the configured record storage and prints the
reference's line of record counts.  Without it the binary serves until
SIGINT or SIGTERM, then stops what it started in the reference's order
and exits 0.  ``--scorer-blob PATH`` (the port's own option) reads an
exported scorer artifact and installs K1's fused scorer as ``serve``'s
``scorer_blob`` does, so a scheduler started as a child process ranks
with the same weights as one composed in process.  With
``server.grpc_port >= 0`` serve mode also binds ``SchedulerGRPCServer``
(the bidi push-reschedule stream and its ``PeerStreamHub``) over the
same service, and with ``scheduling.stall_max_idle_s > 0`` the
``StallMonitor`` sweeps idle subscribed peers; a ``grpc://`` trainer
address uploads over ``GRPCTrainerClient``.  On a machine without the
``grpc`` or ``protobuf`` package these exit 2 naming it.  A config
file loads as the reference's does: a key neither package knows, or a
value its validation refuses, exits 2 with the loader's message.  As in the
reference, ``run`` starts the diagnostics sidecar (``metrics``: port
8000 by default; a port in use only warns), points the process tracer at ``--otlp`` /
``--trace-file``, attaches the flight recorder (``--trace-log`` or
``tracing.log_path``) and starts the metric journal (``--metric-journal``
or ``telemetry.journal_path``) and the SLO engine (``telemetry.slos``);
it stops the journal and the engine on shutdown.  ``build`` passes the
reference's cold-task seed trigger, ``RemoteSeedPeerClient``, which dials
the ``/obtain_seeds`` endpoint of an announced seed daemon; a caller whose
seed hosts are synthetic (no daemon answers their port) passes
``seed_trigger=False``.

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
from .common import (
    SignalWait,
    base_parser,
    grpc_transport,
    init_debug,
    init_diagnostics,
    init_flight_recorder,
    init_logging,
    init_telemetry,
    init_tracing,
    stop_telemetry,
)

# The name the serving slice gave the scheduler's config.
SchedulerConfig = SchedulerConfigFile


def build(
    cfg: Optional[SchedulerConfigFile] = None,
    *,
    device="cuda",
    scorer_blob: Optional[bytes] = None,
    rng: Optional[random.Random] = None,
    seed_trigger: bool = True,
) -> SchedulerService:
    """Composition root (scheduler.go:69-301 New).

    ``device`` is where a fused scorer serves (``"cuda"`` unless the
    caller asks for the CPU; no CUDA device raises).  ``scorer_blob`` is
    an exported scorer artifact (``trainer.export.scorer_to_bytes``) for
    the ``ml`` algorithm.  ``rng`` drives candidate sampling and the probe
    store's choice of probe targets (one generator for both, as the
    reference's process-global ``random``).  ``seed_trigger`` installs
    the cold-task trigger that dials an announced seed daemon (False:
    none, for fleets whose seed hosts no daemon serves).  The service
    carries ``.storage`` and ``.networktopology`` (None when
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
    # Cold-task seed trigger: dials an announced seed daemon's
    # /obtain_seeds stream (seed_peer.go:93-229 TriggerDownloadTask) —
    # returns fast with False when no seed peer has announced.
    from ..scheduler.seed_client import RemoteSeedPeerClient

    return SchedulerService(
        resource, scheduling, storage, topology,
        seed_peer_trigger=RemoteSeedPeerClient(resource) if seed_trigger else None,
    )


@dataclass
class SchedulerServing:
    """What ``serve`` started; ``stop()`` stops it in the reference's
    order (cli/scheduler.py:577-601), then the GC runner, then the
    metric journal and the SLO engine when the binary handed them over."""

    service: SchedulerService
    rpc_server: object
    runner: dfgc.GC
    scheduler_id: str
    topology_state_path: Optional[str] = None
    grpc_server: object = None
    stall_monitor: object = None
    cluster_link: object = None
    job_worker: object = None
    dynconfig: object = None
    topology_sync: object = None
    model_subscriber: object = None
    rollout_reporter: object = None
    announcer: object = None
    shard_guard: object = None
    qos_autopilot: object = None
    journal: object = None
    slo_engine: object = None
    diagnostics: object = None
    identity: object = None

    @property
    def url(self) -> str:
        return self.rpc_server.url

    def stop(self) -> None:
        self.rpc_server.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.stall_monitor is not None:
            self.stall_monitor.stop()
        if self.announcer is not None:
            self.announcer.stop()
        if self.job_worker is not None:
            self.job_worker.stop()
        if self.cluster_link is not None:
            self.cluster_link.stop()
        if self.dynconfig is not None:
            self.dynconfig.stop()
        if self.qos_autopilot is not None:
            self.qos_autopilot.close()
        if self.rollout_reporter is not None:
            self.rollout_reporter.stop()
        if self.model_subscriber is not None:
            self.model_subscriber.stop()
        if self.topology_sync is not None:
            self.topology_sync.stop()  # final disk checkpoint
        elif self.topology_state_path is not None:
            self.service.networktopology.save(self.topology_state_path)
        self.runner.stop()
        stop_telemetry(self.journal, self.slo_engine)
        if self.diagnostics is not None:
            self.diagnostics.stop()


def _job_worker(service: SchedulerService, manager_endpoints, scheduler_id: str, token):
    """The remote job worker on ``scheduler:<id>`` (reference
    cli/scheduler.py:343-369): preheat warms each URL into an announced
    seed daemon through the service's trigger (job.go:244-283 →
    TriggerDownloadTask); sync_peers dumps the host manager."""
    from ..jobs.preheat import PREHEAT
    from ..jobs.remote import RemoteJobWorker
    from ..jobs.sync_peers import SYNC_PEERS, make_sync_peers_handler
    from ..utils import idgen

    job_worker = RemoteJobWorker(
        manager_endpoints, f"scheduler:{scheduler_id}", token=token
    )

    def preheat_handler(args):
        # Warm each URL into an announced seed daemon via the
        # ObtainSeeds trigger (job.go:244-283 → TriggerDownloadTask).
        if service.seed_peer_trigger is None:
            raise RuntimeError("no seed trigger configured")
        results = {}
        for url in args.get("urls", []):
            if not service.seed_peer_trigger(url, idgen.task_id(url)):
                raise RuntimeError(f"preheat of {url}: no seed served it")
            results[url] = "seeded"
        return results

    job_worker.register(PREHEAT, preheat_handler)
    job_worker.register(SYNC_PEERS, make_sync_peers_handler(service.resource))
    return job_worker


def _dynconfig(cfg: SchedulerConfigFile, service: SchedulerService, manager_endpoints,
               shard_guard):
    """Cluster-scoped scheduling config, applied LIVE (reference
    cli/scheduler.py:371-452): the manager's scheduler-cluster record
    feeds candidate/filter limits through dynconfig, and the scheduling
    pass reads the shared SchedulingConfig on every call — a console
    update changes the very next pass (scheduling.go:404-410
    consumption; the disk cache keeps the last-known config through
    manager outages)."""
    import json as _json
    import logging as _logging
    import urllib.error as _urlerror
    import urllib.request as _request

    from ..manager.dynconfig import Dynconfig

    _dynlog = _logging.getLogger("dragonfly2_tpu_torch.cli.scheduler.dynconfig")
    _warned_404 = []

    def _fetch_one_endpoint(base):
        req = _request.Request(
            f"{base}/api/v1/clusters/{cfg.cluster_id}:config"
        )
        try:
            with _request.urlopen(req, timeout=10) as resp:
                return _json.loads(resp.read())
        except _urlerror.HTTPError as exc:
            if exc.code == 404 and not _warned_404:
                # Misconfiguration, not an outage: the manager has no
                # record for this cluster_id, so console updates will
                # never reach this scheduler — say so ONCE, loudly
                # (Dynconfig's refresh swallows fetch errors silently).
                _warned_404.append(True)
                _dynlog.warning(
                    "cluster %r has no config record on the manager — "
                    "live scheduling overrides are inactive until it "
                    "is created (POST /api/v1/clusters)", cfg.cluster_id,
                )
            raise

    def _fetch_cluster_config():
        # Sweep the replica list before giving up: the disk cache is the
        # LAST resort (all replicas down), not the answer to one dead
        # leader.
        return manager_endpoints.call(_fetch_one_endpoint)

    def _apply_cluster_config(data):
        scc = data.get("scheduler_cluster_config")
        if not isinstance(scc, dict):
            return
        sc = service.scheduling.config
        # Read-validate EVERYTHING before writing anything — a bad value
        # must not leave the live config half-updated (the manager
        # validates writes, but the disk cache or an older manager may
        # still hand back junk).
        updates = {}
        for key in (
            "candidate_parent_limit",
            "filter_parent_limit",
            "retry_limit",
            "retry_back_to_source_limit",
        ):
            if key in scc:
                try:
                    updates[key] = int(scc[key])
                except (TypeError, ValueError):
                    _dynlog.warning(
                        "ignoring cluster config with bad %s=%r",
                        key, scc[key],
                    )
                    return
        for key, value in updates.items():
            setattr(sc, key, value)

    # The storage dir may not exist before record storage's first flush.
    os.makedirs(cfg.storage.dir, exist_ok=True)
    dynconfig = Dynconfig(
        _fetch_cluster_config,
        refresh_interval=cfg.dynconfig_refresh_s,
        cache_path=os.path.join(cfg.storage.dir, "dynconfig_cache.json"),
    )
    dynconfig.register(_apply_cluster_config)
    # Ring adoption: the manager publishes the shard ring with the
    # cluster config; a version bump triggers the guard's handoff
    # sweep (tasks this shard no longer owns steer to their new
    # owner on the peers' next call).
    dynconfig.register(shard_guard.on_config)
    # Tenant QoS adoption (DESIGN.md §26): the manager publishes the
    # per-tenant table with the same payload; the service installs it
    # across admission accounting + the batcher's DRR weights and
    # re-publishes it on announce answers.
    dynconfig.register(service.on_qos_config)
    return dynconfig


def _trainer_link(addr: str, grpc_mod):
    """The Announcer's trainer: ``RemoteTrainer`` over HTTP, or for a
    ``grpc://`` address the Train-stream client adapted to the
    announcer's ``open_train_stream`` session surface (reference
    cli/scheduler.py:504-538)."""
    if not addr.startswith("grpc://"):
        from ..rpc import RemoteTrainer

        return RemoteTrainer(addr)
    client = grpc_mod.GRPCTrainerClient(addr[len("grpc://"):])

    class _Session:
        def __init__(self, ip, hostname, scheduler_id):
            self._ident = dict(ip=ip, hostname=hostname, scheduler_id=scheduler_id)
            self.downloads = []
            self.topologies = []

        def send_download_shard(self, path):
            self.downloads.append(path)

        def send_network_topology_shard(self, path):
            self.topologies.append(path)

        def close_and_train(self):
            return client.train(
                **self._ident, download_shards=self.downloads,
                topology_shards=self.topologies,
            )

    class _GRPCTrainerLink:
        def open_train_stream(self, *, ip, hostname, scheduler_id):
            return _Session(ip, hostname, scheduler_id)

    return _GRPCTrainerLink()


def _issue_identity(cfg: SchedulerConfigFile):
    """Auto-issued mTLS (certify analog, reference cli/scheduler.py:
    176-217): this scheduler's identity from the manager's cluster CA;
    the gRPC port then requires CA-issued client certificates."""
    import ipaddress as _ipa

    from ..security.ca import PeerIdentity
    from ..utils.hostinfo import local_ip

    # The SAN must carry the address clients DIAL (gRPC verifies the
    # target against it) — the advertise address, never the bind host
    # (0.0.0.0 would fail every handshake).  A non-IP dial address is a
    # DNS name and belongs in the DNS SANs.
    dial = cfg.server.advertise_ip or (
        cfg.server.host
        if cfg.server.host not in ("0.0.0.0", "::")
        else local_ip()
    )
    try:
        _ipa.ip_address(dial)
        san_ips, san_names = [dial], [socket.gethostname()]
    except ValueError:
        san_ips, san_names = [local_ip()], [dial, socket.gethostname()]
    identity = PeerIdentity.request_from_manager(
        # One-shot bootstrap: the first replica in a comma-separated
        # manager_addr list.
        cfg.manager_addr.split(",")[0].strip(),
        common_name=f"sched-{socket.gethostname()}",
        hostnames=san_names,
        ips=san_ips,
        token=cfg.manager_token or None,
        ttl_hours=cfg.security.cert_ttl_hours,
    )
    if cfg.security.identity_dir:
        identity.write(cfg.security.identity_dir)
    print("scheduler: mTLS identity issued by manager CA", flush=True)
    return identity


def k1_installs(feature_cache: HostFeatureCache, device):
    """The subscription's ``serve_as`` (the port's own): an active model
    that K1 runs (``FusedMLPScorer.runs_k1``) is served as
    ``FusedMLPScorer`` over the host store on ``device``, as a
    ``scorer_blob`` is; any other scorer (the trainers' standardized
    artifacts) serves as ``load_scorer`` returned it, on the host."""

    def serve_as(scorer):
        if FusedMLPScorer.runs_k1(scorer):
            return FusedMLPScorer.from_scorer(feature_cache, scorer, device=device)
        return scorer

    return serve_as


def serve(
    cfg: Optional[SchedulerConfigFile] = None,
    *,
    device="cuda",
    scorer_blob: Optional[bytes] = None,
    rng: Optional[random.Random] = None,
    seed_trigger: bool = True,
    journal=None,
) -> SchedulerServing:
    """The binary's serve mode (reference cli/scheduler.py:167-575) as a
    composition: ``build(cfg, device=, scorer_blob=, rng=,
    seed_trigger=)`` behind
    ``SchedulerHTTPServer`` on ``server.host:server.port`` (0 binds an
    ephemeral port), with the GC runner, the probe-graph checkpoint, the
    shard guard, the manager link and the trainer link the config asks
    for.  ``journal`` is the binary's metric journal
    (``utils.metric_journal.MetricJournal``): with it, admission on and
    ``telemetry.slos`` declared, the SLO autopilot ingests every
    snapshot it writes (reference cli/scheduler.py:267-304).  A
    ``scorer_blob`` installs K1's fused scorer, so announces arriving
    over HTTP are ranked by K1; the subscription installs each active
    model through ``k1_installs``, so a model K1 runs is ranked by K1
    too, and a standardized one on the host.  With ``server.grpc_port >= 0`` the gRPC
    server binds the same service (and the stall monitor starts when
    ``scheduling.stall_max_idle_s > 0``); a ``grpc://`` trainer uploads
    over gRPC.  Raises ``ConfigError`` naming the package when either
    needs ``grpc`` or ``protobuf`` and the machine lacks it.  With
    ``security.auto_issue`` the scheduler requests its identity from the
    manager's CA first (``manager_token`` authenticates the request; no
    ``manager_addr`` raises ``ConfigError``), and its gRPC port requires
    CA-issued client certificates."""
    cfg = cfg or SchedulerConfigFile()
    cfg.validate()
    trainer_link = cfg.trainer.enable and cfg.trainer.addr
    grpc_mod = None
    if cfg.server.grpc_port >= 0:
        grpc_mod = grpc_transport("server.grpc_port >= 0")
    if trainer_link and cfg.trainer.addr.startswith("grpc://"):
        grpc_mod = grpc_transport("a grpc:// trainer.addr")
    identity = None
    if cfg.security.auto_issue:
        if not cfg.manager_addr:
            raise ConfigError("security.auto_issue needs manager_addr")
        identity = _issue_identity(cfg)
    from ..rpc import SchedulerHTTPServer
    from ..rpc.ratelimit import maybe_bucket

    service = build(cfg, device=device, scorer_blob=scorer_blob, rng=rng,
                    seed_trigger=seed_trigger)
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
    # Both transports bind the SAME service: HTTP/JSON and binary gRPC
    # (pkg/rpc serves gRPC in the reference; JSON stays for curl/debug).
    grpc_server = stall_monitor = None
    if cfg.server.grpc_port >= 0:
        grpc_creds = None
        if identity is not None:
            grpc_creds = grpc_mod.grpc.ssl_server_credentials(
                [(identity.key_pem, identity.cert_pem)],
                root_certificates=identity.ca_pem,
                require_client_auth=True,
            )
        # ONE shared bucket: the configured qps bounds the SERVICE, not
        # each transport separately.
        grpc_server = grpc_mod.SchedulerGRPCServer(
            service, host=cfg.server.host, port=cfg.server.grpc_port,
            rate_limit=bucket,
            server_credentials=grpc_creds,
        )
        grpc_server.serve()
        # Stall sweep: server-initiated reschedules for idle peers on the
        # bidi wire (push.StallMonitor; needs the hub the gRPC server
        # attached to the service).
        if cfg.scheduling.stall_max_idle_s > 0:
            from ..scheduler.push import StallMonitor

            stall_monitor = StallMonitor(
                service,
                max_idle_s=cfg.scheduling.stall_max_idle_s,
                interval_s=cfg.scheduling.stall_sweep_interval_s,
            )
            stall_monitor.start()
    # ONE identity for registration and the announcer's keepalive tick;
    # the serving port joins the id so replicas on one host stay
    # distinct in the manager's cluster table.
    scheduler_id = f"sched-{socket.gethostname()}-{rpc_server.address[1]}"
    serving = SchedulerServing(
        service=service, rpc_server=rpc_server, runner=runner,
        scheduler_id=scheduler_id, topology_state_path=topology_state_path,
        grpc_server=grpc_server, stall_monitor=stall_monitor, identity=identity,
    )
    # Sharded-fleet guard (DESIGN.md §24): ownership steering + admission
    # control on the task-scoped entry points.  The ring arrives through
    # dynconfig (below) once a manager publishes it; until then the
    # guard is pass-through (single-shard behavior).
    from ..scheduler.sharding import AdmissionController, ShardGuard

    shard_admission = None
    if cfg.scheduling.shard_max_inflight > 0:
        from ..qos.accounting import TenantAccounting

        # Tenant accounting rides admission from boot (DESIGN.md §26):
        # per-tenant usage/caps start on the default policy and adopt
        # the manager-published tenant_qos via dynconfig below.
        shard_admission = AdmissionController(
            max_inflight=cfg.scheduling.shard_max_inflight,
            p99_budget_s=cfg.scheduling.shard_p99_budget_ms / 1e3,
            accounting=TenantAccounting(),
        )
        if cfg.scheduling.qos_autopilot and journal is not None and cfg.telemetry.slos:
            # SLO autopilot (qos/autopilot.py): rides the metric
            # journal's cadence — every written frame is ingested live,
            # so journal replay reproduces the decisions exactly.
            from ..qos.autopilot import SLOAutopilot

            serving.qos_autopilot = SLOAutopilot(
                cfg.telemetry.slos,
                admission=shard_admission,
                accounting=shard_admission.accounting,
            )
            journal.on_snapshot = serving.qos_autopilot.ingest
    serving.shard_guard = ShardGuard(scheduler_id, admission=shard_admission)
    serving.shard_guard.resource = service.resource
    service.shard_guard = serving.shard_guard
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
        serving.job_worker = _job_worker(service, manager_endpoints, scheduler_id, token)
        serving.job_worker.serve()
        serving.dynconfig = _dynconfig(cfg, service, manager_endpoints,
                                       serving.shard_guard)
        serving.dynconfig.serve()
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
                serve_as=k1_installs(service.scheduling.evaluator.feature_cache, device),
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
            trainer=_trainer_link(cfg.trainer.addr, grpc_mod),
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
        + (f" and grpc on {grpc_server.target}" if grpc_server else "")
        + (f", dataset uploads to {cfg.trainer.addr} every "
           f"{cfg.trainer.interval_s:.0f}s" if serving.announcer else "")
        + (f", job queue {serving.job_worker.queue_name} on {cfg.manager_addr}"
           if serving.job_worker else "")
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
    p.add_argument("--scorer-blob", default="", metavar="PATH",
                   help="an exported scorer artifact: serve mode ranks with K1's "
                   "fused scorer over it (scheduling.algorithm ml)")
    args = p.parse_args(argv)
    init_logging(args, "scheduler")
    debug = init_debug(args)
    init_tracing(args)
    journal = engine = diagnostics = signals = None
    try:
        try:
            cfg = load_config(SchedulerConfigFile, args.config)
            init_flight_recorder(args, cfg.tracing, "scheduler")
            journal, engine = init_telemetry(args, cfg.telemetry, "scheduler")
            diagnostics = init_diagnostics(cfg.metrics, "scheduler")
            if not args.simulate:
                signals = SignalWait()
                blob = None
                if args.scorer_blob:
                    with open(args.scorer_blob, "rb") as f:
                        blob = f.read()
                serving = serve(cfg, device=args.device, scorer_blob=blob,
                                journal=journal)
                serving.journal, serving.slo_engine = journal, engine
                serving.diagnostics = diagnostics
        except ConfigError as exc:
            print(f"scheduler: {exc}", file=sys.stderr)
            return 2
        if not args.simulate:
            signals.wait()
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
        if signals is not None:
            signals.close()
        stop_telemetry(journal, engine)
        if diagnostics is not None:
            diagnostics.stop()
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
