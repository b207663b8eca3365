"""manager service binary (reference: cmd/manager + manager/manager.go).

Port of the single-node form of ``dragonfly2_tpu/cli/manager.py``.
``build`` boots the control-plane composition: ONE SQLite state backend
at ``registry.blob_dir/manager-state.db`` (the legacy per-store files
migrated into it once), the model registry over a ``BlobStore`` in the
blob directory, the CRUD rows with the default cluster, the rollout
controller under the config's guardrails, the job broker, the cluster
manager with keepalive TTLs and the searcher.  ``serve`` puts
``ManagerRESTServer`` over it and returns a handle (``.url``,
``.stop()``), as the port's other binaries do.  ``--list-models`` prints
the registry persisted under ``registry.blob_dir``.

``run(argv)`` is the binary: it prints ``manager: serving REST on <url>
(ctrl-c to stop)``, serves until SIGINT or SIGTERM and exits 0.  What is
not ported exits 2 naming its ROADMAP queue 1 item: ``--replicate-from``
and the config's ``ha``, ``token_secret``, ``users_db``,
``root_password``, ``oauth_providers``, ``ca_dir``, ``objectstorage`` and
``metrics`` keys (item 14), and ``server.grpc_port >= 0`` (item 12c).
As in the reference, ``run`` points the process tracer at ``--otlp`` /
``--trace-file``, attaches the flight recorder and starts the metric
journal and the SLO engine; it stops the journal and the engine on
shutdown.

    DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR=DIR DRAGONFLY_MANAGER_SERVER_PORT=0 \\
        python -m dragonfly2_tpu_torch.cli.manager [--config m.yaml] [--list-models]
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

from ..config import ConfigError, ManagerConfig, load_config
from ..jobs import JobQueue
from ..manager import ClusterManager, ModelRegistry, Searcher
from ..manager.registry import BlobStore
from .common import (
    base_parser,
    init_debug,
    init_flight_recorder,
    init_logging,
    init_telemetry,
    init_tracing,
    stop_telemetry,
    wait_for_signal,
)


def _build_consumers(cfg: ManagerConfig, backend, blob_store):
    """The backend-fed composition pieces (the reference rebuilds them on
    a standby after every replicated batch; here they are built once)."""
    from ..manager.crud import CrudStore
    from ..rollout import RolloutController, RolloutGuardrails

    registry = ModelRegistry(blob_store, backend=backend)
    crud = CrudStore(backend=backend)
    rollout = RolloutController(
        registry,
        guardrails=RolloutGuardrails(
            min_shadow_samples=cfg.rollout.min_shadow_samples,
            min_canary_samples=cfg.rollout.min_canary_samples,
            max_regret_ratio=cfg.rollout.max_regret_ratio,
            regret_slack=cfg.rollout.regret_slack,
            max_inversion_ratio=cfg.rollout.max_inversion_ratio,
            max_psi=cfg.rollout.max_psi,
            canary_percent=cfg.rollout.canary_percent,
        ),
        backend=backend,
    )
    return {
        "registry": registry,
        "crud": crud,
        "rollout": rollout,
        "jobs": JobQueue(backend=backend),
    }


def build(cfg: ManagerConfig):
    """Composition root (manager.go New, single node) → its parts."""
    # ONE durable state backend for every manager surface (manager/
    # state.py seam): registry rows, CRUD rows, the job broker, the
    # shared topology cache — a restart reloads all of it from one place.
    from ..manager.state import make_state_backend, migrate_legacy_sqlite

    backend = make_state_backend(
        os.path.join(cfg.registry.blob_dir, "manager-state.db")
    )
    # Pre-seam deployments kept per-store files; import them once so an
    # upgrade never silently drops models/CRUD rows.
    migrated = migrate_legacy_sqlite(
        backend,
        models_db=os.path.join(cfg.registry.blob_dir, "manager.db"),
        crud_db=os.path.join(cfg.registry.blob_dir, "crud.db"),
    )
    if migrated:
        print(f"manager: migrated legacy state {migrated}", flush=True)
    blob_store = BlobStore(cfg.registry.blob_dir)
    clusters = ClusterManager(keepalive_ttl=cfg.keepalive_ttl_s)
    # Rollout controller (rollout/controller.py): evidence-gated
    # SHADOW→CANARY→ACTIVE promotion with auto-rollback; its rows ride
    # the same state backend, so in-flight rollouts survive a bounce.
    consumers = _build_consumers(cfg, backend, blob_store)
    consumers["crud"].ensure_default_cluster()
    # NOTE: no DynconfigServer here — the dynconfig payload schedulers
    # poll is served straight from the CrudStore's cluster rows
    # (/api/v1/clusters/<id>:config), one source of truth.
    return {
        "registry": consumers["registry"],
        "clusters": clusters,
        "searcher": Searcher(),
        "jobs": consumers["jobs"],
        "crud": consumers["crud"],
        "state_backend": backend,
        "rollout": consumers["rollout"],
        "blob_store": blob_store,
    }


@dataclass
class ManagerServing:
    """What ``serve`` started; ``stop()`` stops the REST server, then the
    metric journal and the SLO engine when the binary handed them over."""

    parts: dict
    rest: object
    journal: object = None
    slo_engine: object = None

    @property
    def url(self) -> str:
        return self.rest.url

    def stop(self) -> None:
        self.rest.stop()
        stop_telemetry(self.journal, self.slo_engine)


def serve(cfg: Optional[ManagerConfig] = None) -> ManagerServing:
    """The binary's serve mode (reference cli/manager.py:138-351, single
    node) as a composition: ``ManagerRESTServer`` over ``build(cfg)`` on
    ``server.host:server.port`` (0 binds an ephemeral port), with the
    config's rate limit and ``jobs_min_requeue_s``.  Raises
    ``ConfigError`` for a gRPC port, before anything is built."""
    cfg = cfg or ManagerConfig()
    cfg.validate()
    if cfg.server.grpc_port >= 0:
        raise ConfigError(
            "server.grpc_port >= 0 asks for the gRPC transport, "
            "which is not ported yet (ROADMAP queue 1 item 12c)"
        )
    from ..manager.rest import ManagerRESTServer
    from ..rpc.ratelimit import maybe_bucket

    parts = build(cfg)
    bucket = maybe_bucket(cfg.server.rate_limit_qps, cfg.server.rate_limit_burst)
    rest = ManagerRESTServer(
        parts["registry"], parts["clusters"], parts["searcher"],
        host=cfg.server.host, port=cfg.server.port,
        jobqueue=parts["jobs"], crud=parts["crud"],
        rate_limit=bucket,
        state_backend=parts["state_backend"],
        jobs_min_requeue_s=cfg.jobs_min_requeue_s,
        rollout=parts["rollout"],
    )
    rest.serve()
    # flush: under a pipe (supervisors, e2e harnesses) the ready line must
    # be visible immediately, not at buffer-fill.
    print(f"manager: serving REST on {rest.url} (ctrl-c to stop)", flush=True)
    return ManagerServing(parts=parts, rest=rest)


def run(argv=None) -> int:
    """The binary's body; → exit code."""
    p = base_parser("manager", "Control-plane manager service")
    p.add_argument("--list-models", action="store_true")
    p.add_argument(
        "--replicate-from", default="", metavar="URL",
        help="boot as a hot standby tailing this leader's replication log "
             "(not ported: ROADMAP queue 1 item 14)",
    )
    args = p.parse_args(argv)
    init_logging(args, "manager")
    debug = init_debug(args)
    init_tracing(args)
    journal = engine = None
    try:
        if args.replicate_from:
            print("manager: --replicate-from: manager replication is not ported yet "
                  "(ROADMAP queue 1 item 14)", file=sys.stderr)
            return 2
        try:
            cfg = load_config(ManagerConfig, args.config)
            init_flight_recorder(args, cfg.tracing, "manager")
            journal, engine = init_telemetry(args, cfg.telemetry, "manager")
            if not args.list_models:
                serving = serve(cfg)
        except ConfigError as exc:
            print(f"manager: {exc}", file=sys.stderr)
            return 2
        if args.list_models:
            models = build(cfg)["registry"].list()
            if not models:
                print("manager: registry empty")
            for m in models:
                print(
                    f"manager: {m.name} v{m.version} type={m.type} state={m.state.value} "
                    f"scheduler={m.scheduler_id} eval={m.evaluation}"
                )
            return 0
        serving.journal, serving.slo_engine = journal, engine
        wait_for_signal()
        serving.stop()
        return 0
    finally:
        stop_telemetry(journal, engine)
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
