"""Config dataclasses + YAML/env loading + validation: the trainer's, the
scheduler's, the manager's and the peer daemon's.

Port of the part of ``dragonfly2_tpu/config/schema.py`` that the trainer
and scheduler binaries read: ``ConfigError``, the sections
``TrainerConfigFile`` holds, ``_from_dict``, ``_apply_env`` and
``load_config``, verbatim (same keys, defaults, validation and
``DRAGONFLY_TRAINER_*`` / ``DRAGONFLY_SCHEDULER_*`` /
``DRAGONFLY_MANAGER_*`` / ``DRAGONFLY_DAEMON_*`` environment overrides), so the reference's
trainer files load.  ``yaml`` is imported
only when a path is given.  The other binaries' config files come with
their slices.

``SchedulerConfigFile`` holds the reference's sections and fields
(``server``, ``scheduling``, ``network_topology``, ``storage``,
``trainer``, ``gc``, ``metrics``, ``log``, ``security``, the manager
link, the dynconfig and topology sync cadences), with its names,
defaults and validation, so every file the reference's scheduler loads
loads here and a key neither knows is refused as unknown.  As in the
reference, ``log`` and ``scheduling.back_to_source_count`` are
validated and read by nothing else.

``SchedulerConfigFile`` also holds the ``tracing`` and ``telemetry``
sections, and the shard guard's settings: ``scheduling.shard_max_inflight``
and ``shard_p99_budget_ms`` (the admission bounds; 0 in-flight builds the
guard without admission) and ``qos_autopilot`` (the SLO autopilot, built
beside admission when a metric journal and ``telemetry.slos`` are
present), as in the reference.

The trainer binary reads ``training.epochs``, ``training.learning_rate``,
``training.warmup_steps``, ``server``, ``data_dir``, ``manager_addr``,
the ``lifecycle`` section and the ``tracing`` and ``telemetry``
sections; every other key parses and is ignored, as in the reference's
trainer binary.  ``telemetry.slos`` is
validated by ``utils/slo.parse_slos``, as in the reference.

``ManagerConfig``, ``ModelRegistrySection`` and ``RolloutSection`` are
the reference's, with ``DRAGONFLY_MANAGER_*`` overrides (``token_secret``,
``users_db``, ``root_password``, ``oauth_providers``, ``ca_dir``,
``objectstorage`` and ``ha`` included).  ``HASection`` (manager
replication) refuses the public default ``lease_secret`` and secrets
under 16 bytes once HA is on, as the reference's does.

``DaemonConfig``, ``DaemonStorageSection``, ``ProxySection`` (with the
SNI proxy's ``sni_*`` keys) and ``SecuritySection`` (the daemon's and the
scheduler's ``security``) are the reference's.

The scheduler's, the manager's and the daemon's ``metrics`` section is
the reference's ``MetricsConfig`` (on, port 8000): the diagnostics
sidecar of ``cli/common.init_diagnostics`` on the scheduler and the
daemon, the same routes on the manager's REST port.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Type, TypeVar

T = TypeVar("T")

ENV_PREFIX = "DRAGONFLY"


class ConfigError(ValueError):
    pass


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 8002
    advertise_ip: str = ""
    # Binary gRPC listener alongside the JSON transport; -1 = disabled,
    # 0 = OS-assigned ephemeral.
    grpc_port: int = -1
    # Token-bucket server rate limit (pkg/rpc interceptor.go); 0 = off.
    rate_limit_qps: float = 0.0
    rate_limit_burst: int = 0

    def validate(self) -> None:
        # 0 = OS-assigned ephemeral port (tests / sidecar deployments).
        if not (0 <= self.port < 65536):
            raise ConfigError(f"server.port {self.port} out of range")
        if not (-1 <= self.grpc_port < 65536):
            raise ConfigError(f"server.grpc_port {self.grpc_port} out of range")


@dataclass
class MetricsConfig:
    enable: bool = True
    port: int = 8000


@dataclass
class TracingSection:
    """Flight recorder (utils/tracing.py DurableSpanExporter).
    ``log_path`` turns on the per-process crash-safe trace log —
    append-only OTLP/JSON frames.  ``sample_rate`` head-samples BY TRACE
    ID (deterministic across processes, so a kept trace is kept on every
    plane).  ``ring_spans`` bounds the in-memory recent ring."""

    enable: bool = True
    log_path: str = ""
    sample_rate: float = 0.1
    ring_spans: int = 4096

    def validate(self) -> None:
        if not (0.0 <= self.sample_rate <= 1.0):
            raise ConfigError("tracing.sample_rate must be in [0, 1]")
        if self.ring_spans < 1:
            raise ConfigError("tracing.ring_spans must be >= 1")


@dataclass
class TelemetrySection:
    """Fleet telemetry plane (utils/metric_journal.py + utils/slo.py).
    ``journal_path`` turns on the per-process crash-safe metric journal
    — append-only digest-checked DFMJ1 frames of periodic
    counter/gauge/sketch snapshots.  ``slos`` declares objectives the SLO
    engine evaluates with multi-window burn-rate alerts (each entry:
    ``name``, ``objective`` latency|availability, ``target``, plus
    ``metric``+``threshold_ms`` or ``good_metric``+``total_metric``;
    optional ``fast_window_s``/``slow_window_s``/``burn_threshold``),
    exported as ``slo_burn_rate{slo}`` / ``slo_breached{slo}`` gauges."""

    journal_path: str = ""
    journal_interval_s: float = 10.0
    slo_interval_s: float = 5.0
    slos: list = field(default_factory=list)

    def validate(self) -> None:
        if self.journal_interval_s <= 0:
            raise ConfigError("telemetry.journal_interval_s must be > 0")
        if self.slo_interval_s <= 0:
            raise ConfigError("telemetry.slo_interval_s must be > 0")
        try:
            from ..utils.slo import parse_slos

            parse_slos(self.slos)
        except ValueError as exc:
            raise ConfigError(f"telemetry.slos: {exc}") from exc


@dataclass
class LogConfig:
    level: str = "info"
    dir: str = ""
    console: bool = False
    max_bytes: int = 50 << 20
    backups: int = 5

    def validate(self) -> None:
        if self.level not in ("debug", "info", "warning", "error"):
            raise ConfigError(f"log.level {self.level!r} unknown")


@dataclass
class TrainingSection:
    epochs: int = 30
    learning_rate: float = 3e-3
    warmup_steps: int = 20
    batch_size: int = 4096
    checkpoint_dir: str = ""

    def validate(self) -> None:
        if self.learning_rate <= 0:
            raise ConfigError("training.learning_rate must be > 0")
        if self.epochs < 1:
            raise ConfigError("training.epochs must be >= 1")


@dataclass
class LifecycleSection:
    """The lifecycle daemon's settings: with ``enable`` and a REST
    manager, the trainer's serve mode runs the daemon with them."""

    enable: bool = False
    model_name: str = "parent-bandwidth-mlp"
    # Comma-free region list: one regional arm (``model_name@region``)
    # is trained next to the global arm per entry.
    regions: tuple = ()
    epoch_records: int = 1024          # records per key between epochs
    max_steps_per_epoch: int = 50
    min_joined: int = 50               # arbitration evidence floor
    arbitration_margin: float = 0.02   # regional must beat global by this
    canary_percent: int = 10
    interval_s: float = 30.0           # daemon loop cadence
    trainer_batch_size: int = 256

    def validate(self) -> None:
        # YAML hands lists in; the daemon wants a hashable tuple.
        self.regions = tuple(self.regions or ())
        if self.epoch_records < 1:
            raise ConfigError("lifecycle.epoch_records must be >= 1")
        if self.max_steps_per_epoch < 1:
            raise ConfigError("lifecycle.max_steps_per_epoch must be >= 1")
        if not (0 <= self.canary_percent <= 100):
            raise ConfigError("lifecycle.canary_percent must be in [0, 100]")
        if self.arbitration_margin < 0:
            raise ConfigError("lifecycle.arbitration_margin must be >= 0")
        if self.interval_s <= 0:
            raise ConfigError("lifecycle.interval_s must be > 0")


@dataclass
class TrainerConfigFile:
    server: ServerConfig = field(default_factory=lambda: ServerConfig(port=9090))
    training: TrainingSection = field(default_factory=TrainingSection)
    lifecycle: LifecycleSection = field(default_factory=LifecycleSection)
    data_dir: str = "/var/lib/dragonfly/trainer"
    manager_addr: str = ""
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    tracing: TracingSection = field(default_factory=TracingSection)
    telemetry: TelemetrySection = field(default_factory=TelemetrySection)
    log: LogConfig = field(default_factory=LogConfig)

    def validate(self) -> None:
        self.server.validate()
        self.training.validate()
        self.lifecycle.validate()
        self.log.validate()
        self.tracing.validate()
        self.telemetry.validate()


@dataclass
class StorageConfig:
    dir: str = "/var/lib/dragonfly/records"
    buffer_size: int = 100
    max_size: int = 100 << 20
    max_backups: int = 10


@dataclass
class SchedulingSection:
    """The scheduler's ``scheduling`` section, the reference's fields."""

    algorithm: str = "default"        # default | nt | ml (evaluator.go:28-46)
    candidate_parent_limit: int = 4
    filter_parent_limit: int = 15
    retry_limit: int = 5
    retry_back_to_source_limit: int = 4
    retry_interval_s: float = 0.5
    back_to_source_count: int = 3
    # Server-initiated stall sweep (push.StallMonitor): running peers
    # idle beyond max_idle get fresh parents pushed down the bidi wire.
    # 0 disables the monitor.
    stall_max_idle_s: float = 10.0
    stall_sweep_interval_s: float = 2.0
    # Serving engine (ml algorithm, DESIGN.md §14): bounded linger the
    # cross-request micro-batcher waits to coalesce concurrent announce
    # evaluations into one padded scorer call (0 = flush immediately),
    # and the columnar host store's slot count.
    eval_batch_linger_ms: float = 1.5
    eval_feature_cache_hosts: int = 65536
    # Rollout plane (DESIGN.md §15): registry poll cadence with seeded
    # anti-herd jitter, the shadow-scoring sample fraction, and the
    # evaluate→report cycle interval.
    model_poll_interval_s: float = 300.0
    model_poll_jitter: float = 0.1
    shadow_sample_rate: float = 0.1
    rollout_report_interval_s: float = 60.0
    # Regional model keys (DESIGN.md §29): this scheduler's idc/region.
    # Set, the model subscriber polls the per-region specialization
    # ``<model>@<idc>`` first and falls back to the global model; empty
    # keeps the reference's fleet-wide single-key behaviour.
    idc: str = ""
    # Sharded fleet (DESIGN.md §24): admission control bounds for this
    # shard — concurrent task-scoped requests past max_inflight (and
    # announce p99 past the budget) start shedding the lowest priority
    # classes with 503+Retry-After.  0 max_inflight disables admission.
    shard_max_inflight: int = 512
    shard_p99_budget_ms: float = 50.0
    # Tenant QoS plane (DESIGN.md §26): with telemetry.slos declared, a
    # metric journal configured and admission enabled, the SLO autopilot
    # feeds burn verdicts back into the shed floor + over-quota tenants'
    # announce caps; False leaves admission on the measured signals only.
    qos_autopilot: bool = True

    def validate(self) -> None:
        if self.algorithm not in ("default", "nt", "ml"):
            raise ConfigError(f"scheduling.algorithm {self.algorithm!r} unknown")
        if self.candidate_parent_limit > self.filter_parent_limit:
            raise ConfigError("candidate_parent_limit > filter_parent_limit")
        if self.candidate_parent_limit < 1:
            raise ConfigError("candidate_parent_limit < 1")
        if self.eval_batch_linger_ms < 0:
            raise ConfigError("eval_batch_linger_ms < 0")
        if self.eval_feature_cache_hosts < 1:
            raise ConfigError("eval_feature_cache_hosts < 1")
        if not (0.0 <= self.shadow_sample_rate <= 1.0):
            raise ConfigError("shadow_sample_rate must be in [0, 1]")
        if self.shard_max_inflight < 0:
            raise ConfigError("shard_max_inflight < 0")
        if self.shard_p99_budget_ms <= 0:
            raise ConfigError("shard_p99_budget_ms <= 0")
        if not (0.0 <= self.model_poll_jitter < 0.5):
            raise ConfigError("model_poll_jitter must be in [0, 0.5)")


@dataclass
class NetworkTopologySection:
    enable: bool = True
    probe_queue_length: int = 5
    probe_count: int = 5
    collect_interval_s: float = 2 * 3600.0


@dataclass
class TrainerLinkSection:
    enable: bool = False
    addr: str = ""
    interval_s: float = 7 * 24 * 3600.0  # constants.go:198


@dataclass
class GCSection:
    host_ttl_s: float = 6 * 3600.0
    task_ttl_s: float = 2 * 3600.0
    peer_ttl_s: float = 24 * 3600.0
    interval_s: float = 60.0


@dataclass
class SecuritySection:
    """Auto-issued mTLS (the reference certify flow, pkg/rpc/security):
    with ``auto_issue`` on and a manager address configured, the service
    requests its identity from the manager's cluster CA at boot
    (security/ca.py request_from_manager) — the key never leaves the
    process; only the CSR travels."""

    auto_issue: bool = False
    identity_dir: str = ""     # persist key/cert/ca here (empty = memory only)
    # 0 = manager default (24h); server-capped at 7d.  The daemon's
    # piece-plane contexts auto-renew in place at half validity
    # (security.ca.IdentityRenewer); gRPC credentials are immutable once
    # built — clusters running mTLS gRPC restart services within the TTL.
    cert_ttl_hours: int = 0
    # Daemon-side: dial the scheduler's gRPC port with TLS when this
    # daemon holds an issued identity.  True assumes a uniformly mTLS'd
    # cluster (the scheduler auto-issued too); set False for mixed
    # deployments where the scheduler's gRPC port is still plaintext.
    scheduler_grpc_tls: bool = True


@dataclass
class SchedulerConfigFile:
    server: ServerConfig = field(default_factory=ServerConfig)
    scheduling: SchedulingSection = field(default_factory=SchedulingSection)
    network_topology: NetworkTopologySection = field(default_factory=NetworkTopologySection)
    storage: StorageConfig = field(default_factory=StorageConfig)
    trainer: TrainerLinkSection = field(default_factory=TrainerLinkSection)
    gc: GCSection = field(default_factory=GCSection)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    manager_addr: str = ""
    # Bearer credential (PAT or session token) for the manager's RBAC'd
    # registration routes; empty on open managers.
    manager_token: str = ""
    security: SecuritySection = field(default_factory=SecuritySection)
    cluster_id: str = "default"
    # How often to poll the manager for cluster-scoped scheduling config
    # (dynconfig.go refresh interval; the reference defaults to 10s for
    # schedulers).
    dynconfig_refresh_s: float = 10.0
    # Cross-replica probe-graph sync cadence (push own edges, pull the
    # other schedulers' via the manager — the Redis-sharing analog).
    topology_sync_interval_s: float = 30.0
    tracing: TracingSection = field(default_factory=TracingSection)
    telemetry: TelemetrySection = field(default_factory=TelemetrySection)
    log: LogConfig = field(default_factory=LogConfig)

    def validate(self) -> None:
        self.server.validate()
        self.scheduling.validate()
        self.log.validate()
        self.tracing.validate()
        self.telemetry.validate()


@dataclass
class ModelRegistrySection:
    blob_dir: str = "/var/lib/dragonfly/models"


@dataclass
class RolloutSection:
    """Rollout-controller guardrails (rollout/controller.py
    RolloutGuardrails; DESIGN.md §15 documents each threshold)."""

    min_shadow_samples: int = 200
    min_canary_samples: int = 200
    max_regret_ratio: float = 1.10
    regret_slack: float = 0.02
    max_inversion_ratio: float = 1.10
    max_psi: float = 0.25
    canary_percent: int = 10

    def validate(self) -> None:
        if not (0 <= self.canary_percent <= 100):
            raise ConfigError("rollout.canary_percent must be in [0, 100]")
        if self.max_regret_ratio < 1.0 or self.max_inversion_ratio < 1.0:
            raise ConfigError("rollout ratio guardrails must be >= 1.0")
        if self.min_shadow_samples < 1 or self.min_canary_samples < 1:
            raise ConfigError("rollout sample floors must be >= 1")


# Placeholder default for HASection.lease_secret (kept in sync with the
# ReplicatedStateBackend constructor default in manager/replication.py).
# It is PUBLIC CODE: validate() refuses to enable HA with it in place —
# anyone holding it can forge leases (fence a live leader via a fake
# high term, keep a dead one looking alive) and fetch the replication
# log/snapshot, credential rows included.
DEFAULT_LEASE_SECRET = "dragonfly-manager-lease"


@dataclass
class HASection:
    """Manager control-plane replication (manager/replication.py,
    DESIGN.md §20).  ``enable`` turns on log-shipping + the
    /api/v1/replication:* surface on a leader; ``replicate_from`` boots
    this process as a hot standby tailing that leader (implies enable).
    ``lease_secret`` must match across the pair — it signs the leader
    lease followers defer to and authenticates log/snapshot fetches.
    ``peers`` lists the other replicas' base URLs: a node booting as
    leader probes them for a higher term first, so a restarted fenced
    leader rejoins as a standby instead of resurrecting a stale term."""

    enable: bool = False
    replicate_from: str = ""
    node_id: str = ""
    lease_ttl_s: float = 10.0
    lease_secret: str = DEFAULT_LEASE_SECRET
    poll_interval_s: float = 1.0
    peers: list = field(default_factory=list)

    def validate(self) -> None:
        if self.lease_ttl_s <= 0:
            raise ConfigError("ha.lease_ttl_s must be > 0")
        if self.poll_interval_s <= 0:
            raise ConfigError("ha.poll_interval_s must be > 0")
        if self.enable or self.replicate_from:
            if self.lease_secret == DEFAULT_LEASE_SECRET:
                raise ConfigError(
                    "ha.lease_secret must be set to a private value when "
                    "HA is enabled — the default is public code, so any "
                    "peer could forge leases and fetch the replicated "
                    "state (users/PATs rows included)"
                )
            if len(self.lease_secret.encode()) < 16:
                raise ConfigError("ha.lease_secret must be >= 16 bytes")


@dataclass
class ManagerConfig:
    server: ServerConfig = field(default_factory=lambda: ServerConfig(port=65003))
    registry: ModelRegistrySection = field(default_factory=ModelRegistrySection)
    rollout: RolloutSection = field(default_factory=RolloutSection)
    keepalive_ttl_s: float = 60.0
    # RBAC (manager users + PATs): token_secret (>=16 bytes) turns auth
    # on; users_db persists accounts; root_password seeds the first admin.
    token_secret: str = ""
    users_db: str = ""
    root_password: str = ""
    # OAuth2 providers (manager/models/oauth.go rows):
    # [{name, client_id, client_secret, auth_url, token_url, profile_url}]
    oauth_providers: list = field(default_factory=list)
    # Object-storage backend the bucket routes manage (handlers/bucket.go
    # proxies to the configured backend): {"kind": "fs"|"s3"|"oss", ...}
    # — empty disables the bucket surface.
    objectstorage: dict = field(default_factory=dict)
    # Cluster CA directory (pkg/issuer analog): non-empty turns on the
    # certificate-issuance surface (POST /api/v1/certs:issue + gRPC twin)
    # with a persistent CA under this path; peers self-provision mTLS
    # identities at boot (security/ca.py request_from_manager).
    ca_dir: str = ""
    # Floor for the job broker's wire-supplied visibility window: a
    # worker's poll may request faster redelivery of popped-but-
    # unreported jobs, but never below this — an impatient worker must
    # not duplicate every in-flight job on its queue.  Operators shrink
    # it for recovery drills/tests.
    jobs_min_requeue_s: float = 30.0
    ha: HASection = field(default_factory=HASection)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    tracing: TracingSection = field(default_factory=TracingSection)
    telemetry: TelemetrySection = field(default_factory=TelemetrySection)
    log: LogConfig = field(default_factory=LogConfig)

    def validate(self) -> None:
        self.server.validate()
        self.log.validate()
        self.tracing.validate()
        self.telemetry.validate()
        self.rollout.validate()
        self.ha.validate()
        if self.token_secret and len(self.token_secret.encode()) < 16:
            raise ConfigError("token_secret must be >= 16 bytes")
        for p in self.oauth_providers:
            if not isinstance(p, dict) or "name" not in p:
                raise ConfigError(f"oauth provider needs a name: {p!r}")


@dataclass
class DaemonStorageSection:
    dir: str = "/var/lib/dragonfly/daemon"
    quota_bytes: int = 10 << 30


@dataclass
class ProxySection:
    enable: bool = False
    port: int = 65001
    # SNI hijack (client/daemon/proxy hijackHTTPS): TLS listener that
    # terminates matched SNI hosts with CA-minted leaf certs and serves
    # them from P2P; unmatched hosts relay untouched.
    sni_enable: bool = False
    sni_port: int = 65443
    sni_hijack_hosts: list = field(default_factory=list)  # regexes



@dataclass
class DaemonConfig:
    server: ServerConfig = field(default_factory=lambda: ServerConfig(port=65000))
    storage: DaemonStorageSection = field(default_factory=DaemonStorageSection)
    proxy: ProxySection = field(default_factory=ProxySection)
    # Control-API bind (dfget --daemon wire, /download, /obtain_seeds).
    # Loopback by default — /download writes local files; bind a routable
    # host only inside trusted pods/compose networks (the container e2e
    # drives daemons through it).
    control_host: str = "127.0.0.1"
    control_port: int = 0
    # AF_VSOCK control listener for VM guests (pkg/rpc/vsock.go analog);
    # -1 = disabled, 0 = OS-assigned.
    control_vsock_port: int = -1
    scheduler_addr: str = ""
    # Declared tenant identity (DESIGN.md §26): stamped on registers and
    # announces so the scheduler's per-tenant accounting, the upload
    # caps, and the weighted-fair lanes key on it.  Authenticated
    # deployments derive it from the manager credential instead
    # (qos.derive_tenant); "" rides as the default tenant.
    tenant: str = ""
    # Manager address for service-identity bootstrap (daemons otherwise
    # only talk to the scheduler); required when security.auto_issue is on.
    manager_addr: str = ""
    manager_token: str = ""
    security: SecuritySection = field(default_factory=SecuritySection)
    piece_size: int = 4 << 20
    concurrent_upload_limit: int = 50
    # Concurrent back-to-source range groups (peerhost.go ConcurrentOption
    # GoroutineCount); 1 = sequential origin fetch.
    concurrent_source_groups: int = 1
    # Pass-through read plane (DESIGN.md §25): commit-tee buffer depth
    # in pieces per stream consumer; 0 = disable the tee (proxy/gateway
    # streams read every piece back off disk).
    stream_tee_depth: int = 8
    # In-engine piece fetch loop (DESIGN.md §28): the conductor drains a
    # piece window through native pf_* workers when the whole fallback
    # matrix allows (native storage, plain-HTTP transport, no stream
    # consumers, no piece-plane faults).  Off → always the Python arm.
    native_fetch: bool = True
    # Cloud back-to-source credentials by scheme (peerhost.go source
    # plugins): {"s3": {...}, "oss": {...}, "hdfs": {...}, "oras": {...}}
    # — see dragonfly2_tpu_torch.source.configure_sources.
    source: dict = field(default_factory=dict)
    total_rate_limit: float = 1e9
    probe_interval_s: float = 20 * 60.0
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    tracing: TracingSection = field(default_factory=TracingSection)
    telemetry: TelemetrySection = field(default_factory=TelemetrySection)
    log: LogConfig = field(default_factory=LogConfig)

    def validate(self) -> None:
        self.server.validate()
        self.log.validate()
        self.tracing.validate()
        self.telemetry.validate()
        if self.piece_size < 4096:
            raise ConfigError(f"piece_size {self.piece_size} too small")
        if self.stream_tee_depth < 0:
            raise ConfigError(
                f"stream_tee_depth {self.stream_tee_depth} must be >= 0"
            )


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def _from_dict(cls: Type[T], data: dict) -> T:
    kwargs = {}
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    import typing

    resolved = typing.get_type_hints(cls)
    for name, value in (data or {}).items():
        if name not in hints:
            raise ConfigError(f"{cls.__name__}: unknown key {name!r}")
        ftype = resolved[name]
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[name] = _from_dict(ftype, value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _apply_env(obj: Any, prefix: str) -> None:
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        key = f"{prefix}_{f.name}".upper()
        if dataclasses.is_dataclass(value):
            _apply_env(value, key)
            continue
        raw = os.environ.get(key)
        if raw is None:
            continue
        if isinstance(value, bool):
            setattr(obj, f.name, raw.lower() in ("1", "true", "yes", "on"))
        elif isinstance(value, int):
            setattr(obj, f.name, int(raw))
        elif isinstance(value, float):
            setattr(obj, f.name, float(raw))
        else:
            setattr(obj, f.name, raw)


def load_config(cls: Type[T], path: Optional[str] = None, *, env: bool = True) -> T:
    """YAML file (optional) → dataclass; env overrides; validate()."""
    data: dict = {}
    if path:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _from_dict(cls, data)
    if env:
        _apply_env(cfg, f"{ENV_PREFIX}_{cls.__name__.replace('ConfigFile', '').replace('Config', '')}")
    if hasattr(cfg, "validate"):
        cfg.validate()
    return cfg
