"""Config dataclasses + YAML/env loading + validation: the trainer's and
the scheduler's.

Port of the part of ``dragonfly2_tpu/config/schema.py`` that the trainer
and scheduler binaries read: ``ConfigError``, the sections
``TrainerConfigFile`` holds, ``_from_dict``, ``_apply_env`` and
``load_config``, verbatim (same keys, defaults, validation and
``DRAGONFLY_TRAINER_*`` / ``DRAGONFLY_SCHEDULER_*`` environment
overrides), so the reference's trainer files load.  ``yaml`` is imported
only when a path is given.  The other binaries' config files come with
their slices.

``SchedulerConfigFile`` holds only the sections and fields the port's
``cli/scheduler`` reads (``server``, ``scheduling``,
``network_topology``, ``storage``, ``trainer``, ``gc``, the manager
link and the topology sync cadence), with the reference's names,
defaults and validation.  The reference's other scheduler keys come
with the slices that read them, and until then a file that sets one is
refused as an unknown key; for the keys in ``NOT_PORTED`` the message
names the ROADMAP queue 1 item that brings their reader.

The trainer binary reads ``training.epochs``, ``training.learning_rate``,
``training.warmup_steps``, ``server``, ``data_dir``, ``manager_addr`` and
the ``lifecycle`` section; every other key parses and is ignored
(ROADMAP queue 1 item 10 lists what reads them in the reference).
``telemetry.slos`` is not validated: the SLO engine waits for the
telemetry slice.
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
    """Flight-recorder settings; parsed, not read (ROADMAP item 10)."""

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
    """Metric journal and SLO settings; parsed, not read (ROADMAP item 10).
    ``slos`` is kept as given, unvalidated."""

    journal_path: str = ""
    journal_interval_s: float = 10.0
    slo_interval_s: float = 5.0
    slos: list = field(default_factory=list)

    def validate(self) -> None:
        if self.journal_interval_s <= 0:
            raise ConfigError("telemetry.journal_interval_s must be > 0")
        if self.slo_interval_s <= 0:
            raise ConfigError("telemetry.slo_interval_s must be > 0")


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
    """The ``scheduling`` fields ``cli/scheduler.build`` reads."""

    algorithm: str = "default"        # default | nt | ml (evaluator.go:28-46)
    candidate_parent_limit: int = 4
    filter_parent_limit: int = 15
    retry_limit: int = 5
    retry_back_to_source_limit: int = 4
    retry_interval_s: float = 0.5
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
class SchedulerConfigFile:
    server: ServerConfig = field(default_factory=ServerConfig)
    scheduling: SchedulingSection = field(default_factory=SchedulingSection)
    network_topology: NetworkTopologySection = field(default_factory=NetworkTopologySection)
    storage: StorageConfig = field(default_factory=StorageConfig)
    trainer: TrainerLinkSection = field(default_factory=TrainerLinkSection)
    gc: GCSection = field(default_factory=GCSection)
    manager_addr: str = ""
    # Bearer credential (PAT or session token) for the manager's RBAC'd
    # registration routes; empty on open managers.
    manager_token: str = ""
    cluster_id: str = "default"
    # Cross-replica probe-graph sync cadence (push own edges, pull the
    # other schedulers' via the manager — the Redis-sharing analog).
    topology_sync_interval_s: float = 30.0

    def validate(self) -> None:
        self.server.validate()
        self.scheduling.validate()


# Keys of the reference's config files whose readers are not ported yet,
# by the config class that would hold them: a file that sets one is
# refused, and the message names the item that brings the reader.
NOT_PORTED = {
    "SchedulerConfigFile": {
        "security": "14 (the security plane)",
        "dynconfig_refresh_s": "14 (dynconfig)",
        "metrics": "14 (the diagnostics server)",
        "tracing": "10 (tracing)",
        "telemetry": "10 (telemetry)",
    },
    "SchedulingSection": {
        "shard_max_inflight": "14 (the shard guard)",
        "shard_p99_budget_ms": "14 (the shard guard)",
        "qos_autopilot": "10 (the QoS plane)",
        "stall_max_idle_s": "12c (the gRPC push stream)",
        "stall_sweep_interval_s": "12c (the gRPC push stream)",
    },
}


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
            item = NOT_PORTED.get(cls.__name__, {}).get(name)
            if item is not None:
                raise ConfigError(
                    f"{cls.__name__}: key {name!r} is not ported yet "
                    f"(ROADMAP queue 1 item {item})"
                )
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
