"""manager service binary (reference: cmd/manager + manager/manager.go).

Port of ``dragonfly2_tpu/cli/manager.py``.
``build`` boots the control-plane composition: ONE SQLite state backend
at ``registry.blob_dir/manager-state.db`` (the legacy per-store files
migrated into it once), the model registry over a ``BlobStore`` in the
blob directory (with HA, over a ``KVBlobStore`` on the replicated
backend, so artifacts ride the op log with their rows), the CRUD rows
with the default cluster, the rollout controller under the config's
guardrails, the job broker, the cluster
manager with keepalive TTLs, the searcher and, with ``objectstorage``,
the backend the bucket routes drive.  ``serve`` puts
``ManagerRESTServer`` over it and returns a handle (``.url``,
``.stop()``), as the port's other binaries do.  As in the reference,
``token_secret`` turns on the token verifier and issuer and a
``UserStore`` (on the state backend, or in ``users_db`` with its legacy
tables migrated once) with ``root_password`` seeding the ``root`` admin
and ``oauth_providers`` the OAuth sign-in, and ``ca_dir`` the
persistent cluster CA that signs ``certs:issue`` on both ports.  ``--list-models`` prints
the registry persisted under ``registry.blob_dir``.

``run(argv)`` is the binary: it prints ``manager: serving REST on <url>
(ctrl-c to stop)``, serves until SIGINT or SIGTERM and exits 0.

Manager HA (``manager/replication.py``), as in the reference: with
``ha.enable`` the node is a leader over a ``ReplicatedStateBackend`` and
renews its lease (``LeaseKeeper``); with ``--replicate-from URL`` (or
``ha.replicate_from``) it boots as a hot standby whose consumers are
built under ``applying()``, tails the leader (``LogFollower``), rebuilds
the REST surface's consumers after every applied batch and promotes
itself when the leader's lease lapses.  A node booting as leader first
probes ``ha.peers`` and joins as a standby when one holds a higher term.
With HA the boot line carries ``as <role> (term N)``.
``server.grpc_port >= 0`` also serves ``ManagerGRPCServer`` over the same
registry, clusters, credentials and CA; on a machine without ``grpc`` or
``protobuf`` it exits 2 naming the package.  The ``metrics`` section parses, as in the
reference: the manager serves ``/metrics`` and ``/debug/*`` on its REST
port.  As in the reference, ``run`` points the process tracer at ``--otlp`` /
``--trace-file``, attaches the flight recorder and starts the metric
journal and the SLO engine; it stops the journal and the engine on
shutdown.

    DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR=DIR DRAGONFLY_MANAGER_SERVER_PORT=0 \\
        python -m dragonfly2_tpu_torch.cli.manager [--config m.yaml] [--list-models] \\
        [--replicate-from URL]
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
    SignalWait,
    base_parser,
    grpc_transport,
    init_debug,
    init_flight_recorder,
    init_logging,
    init_telemetry,
    init_tracing,
    report_launches,
    stop_telemetry,
)


def _build_consumers(cfg: ManagerConfig, backend, blob_store):
    """The backend-fed composition pieces: rebuilt wholesale by the
    standby every time the replication follower applies a batch (their
    in-memory caches must track the replicated rows)."""
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


def build(cfg: ManagerConfig, *, replicate_from: str = ""):
    """Composition root (manager.go New) → its parts."""
    import socket as _socket

    # ONE durable state backend for every manager surface (manager/
    # state.py seam): registry rows, CRUD rows, the job broker, the
    # shared topology cache, users — a restart reloads all of it from
    # one place, and the HA story swaps one backend, not five files.
    from ..manager.state import make_state_backend, migrate_legacy_sqlite

    replicate_from = replicate_from or cfg.ha.replicate_from
    ha_enabled = bool(cfg.ha.enable or replicate_from)
    backend = make_state_backend(
        os.path.join(cfg.registry.blob_dir, "manager-state.db")
    )
    ha = None
    if ha_enabled:
        from ..manager.replication import ReplicatedStateBackend

        role = "standby" if replicate_from else "leader"
        node_id = cfg.ha.node_id or (
            f"mgr-{_socket.gethostname()}-{cfg.server.port}"
        )
        ha = backend = ReplicatedStateBackend(
            backend,
            node_id=node_id,
            role=role,
            lease_ttl_s=cfg.ha.lease_ttl_s,
            lease_secret=cfg.ha.lease_secret,
        )
    if not replicate_from:
        # Pre-seam deployments kept per-store files; import them once so
        # an upgrade never silently drops models/CRUD rows.  A standby
        # never migrates — its state comes from the leader's snapshot.
        migrated = migrate_legacy_sqlite(
            backend,
            models_db=os.path.join(cfg.registry.blob_dir, "manager.db"),
            crud_db=os.path.join(cfg.registry.blob_dir, "crud.db"),
        )
        if migrated:
            print(f"manager: migrated legacy state {migrated}", flush=True)
    # HA replicates artifacts WITH their registry rows (KVBlobStore rides
    # the same log); the single-node form keeps the blob directory.
    if ha_enabled:
        from ..manager.registry import KVBlobStore

        blob_store = KVBlobStore(backend)
    else:
        blob_store = BlobStore(cfg.registry.blob_dir)
    objectstorage = None
    if cfg.objectstorage:
        from ..objectstorage import make_backend

        kwargs = dict(cfg.objectstorage)
        objectstorage = make_backend(kwargs.pop("kind", "fs"), **kwargs)
    clusters = ClusterManager(keepalive_ttl=cfg.keepalive_ttl_s)
    # Rollout controller (rollout/controller.py): evidence-gated
    # SHADOW→CANARY→ACTIVE promotion with auto-rollback; its rows ride
    # the same state backend, so in-flight rollouts survive a bounce.
    # On a standby the boot-time reconciliation runs under applying()
    # (derived state, not new client mutations).
    if ha is not None and ha.role == "standby":
        with ha.applying():
            consumers = _build_consumers(cfg, backend, blob_store)
    else:
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
        "objectstorage": objectstorage,
        "state_backend": backend,
        "rollout": consumers["rollout"],
        "ha": ha,
        "blob_store": blob_store,
    }


@dataclass
class ManagerServing:
    """What ``serve`` started; ``stop()`` stops the REST server and the
    gRPC server, the lease keeper or the log follower (and the keeper a
    promotion started), then the metric journal and the SLO engine when
    the binary handed them over."""

    parts: dict
    rest: object
    grpc_server: object = None
    journal: object = None
    slo_engine: object = None
    lease_keeper: object = None
    follower: object = None

    @property
    def url(self) -> str:
        return self.rest.url

    def stop(self) -> None:
        self.rest.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.lease_keeper is not None:
            self.lease_keeper.stop()
        if self.follower is not None:
            self.follower.stop()
        stop_telemetry(self.journal, self.slo_engine)


def serve(cfg: Optional[ManagerConfig] = None, *,
          replicate_from: str = "") -> ManagerServing:
    """The binary's serve mode (reference cli/manager.py:138-351) as a
    composition: ``ManagerRESTServer`` over ``build(cfg, replicate_from=)`` on
    ``server.host:server.port`` (0 binds an ephemeral port), with the
    config's rate limit and ``jobs_min_requeue_s``, and with
    ``server.grpc_port >= 0`` ``ManagerGRPCServer`` sharing its rate-limit
    bucket, and the replication role: the leader's ``LeaseKeeper`` or the
    standby's ``LogFollower``.  Raises ``ConfigError`` naming the package,
    before anything is built, when gRPC is asked for and ``grpc`` or
    ``protobuf`` is missing."""
    cfg = cfg or ManagerConfig()
    cfg.validate()
    grpc_mod = None
    if cfg.server.grpc_port >= 0:
        grpc_mod = grpc_transport("server.grpc_port >= 0")
    from ..manager.rest import ManagerRESTServer
    from ..rpc.ratelimit import maybe_bucket

    parts = build(cfg, replicate_from=replicate_from)
    # A node configured as leader first asks its peers (if any) whether
    # a higher term already exists: followers PULL, so nothing would
    # otherwise deliver a successor's term to a restarted fenced leader
    # — it would boot at its stale term and accept writes again.  With a
    # higher term observed it demotes itself and tails that peer.
    replicate_from = replicate_from or cfg.ha.replicate_from
    ha = parts["ha"]
    if ha is not None and ha.role == "leader" and cfg.ha.peers:
        from ..manager.replication import probe_peer_term

        peer_term, peer_url = probe_peer_term(cfg.ha.peers)
        if peer_term > ha.term:
            ha.observe_term(peer_term)
            replicate_from = peer_url
            print(
                f"manager: peer {peer_url} holds term {peer_term}; "
                "joining as standby", flush=True,
            )
    auth = {}
    if cfg.token_secret:
        from ..manager.users import UserStore
        from ..security.tokens import TokenIssuer, TokenVerifier

        secret = cfg.token_secret.encode()
        # users_db (if set) keeps its own file for operators who isolate
        # credentials; default shares the one state backend.  Legacy
        # users/pats tables in that file import once.
        if cfg.users_db:
            from ..manager.state import SQLiteBackend, migrate_legacy_sqlite

            user_backend = SQLiteBackend(cfg.users_db)
            migrate_legacy_sqlite(user_backend, users_db=cfg.users_db)
            users = UserStore(backend=user_backend)
        else:
            users = UserStore(backend=parts["state_backend"])
        if cfg.root_password and not (
            parts["ha"] is not None and parts["ha"].role == "standby"
        ):
            # A standby never seeds accounts — the root user replicates
            # from the leader like every other row.
            users.ensure_root(cfg.root_password)
        auth = {
            "token_verifier": TokenVerifier(secret),
            "token_issuer": TokenIssuer(secret),
            "users": users,
        }
        if cfg.oauth_providers:
            from ..manager.oauth import OAuthProvider, OAuthSignin

            oauth = OAuthSignin(users)
            for p in cfg.oauth_providers:
                oauth.register(OAuthProvider(**p))
            auth["oauth"] = oauth
    ca = None
    if cfg.ca_dir:
        try:
            from ..security.ca import CertificateAuthority
        except ImportError:
            # `cryptography` absent: serve without the CA surface rather
            # than dying at boot — identity issuance degrades to 404,
            # everything else (registry, jobs, topology) keeps working.
            print("manager: ca_dir set but `cryptography` unavailable; "
                  "serving without CA", flush=True)
        else:
            # Persistent: restarts keep the cluster trust root, so issued
            # peer identities stay valid across a manager bounce.
            ca = CertificateAuthority.persistent(cfg.ca_dir)
    parts["auth"], parts["ca"] = auth, ca
    bucket = maybe_bucket(cfg.server.rate_limit_qps, cfg.server.rate_limit_burst)
    rest = ManagerRESTServer(
        parts["registry"], parts["clusters"], parts["searcher"],
        host=cfg.server.host, port=cfg.server.port,
        jobqueue=parts["jobs"], crud=parts["crud"],
        objectstorage=parts["objectstorage"],
        rate_limit=bucket,
        ca=ca,
        state_backend=parts["state_backend"],
        jobs_min_requeue_s=cfg.jobs_min_requeue_s,
        rollout=parts["rollout"],
        ha=parts["ha"],
        **auth,
    )
    rest.serve()
    # -- replication role (manager/replication.py, DESIGN.md §20) -------
    lease_keeper = None
    follower = None
    if ha is not None and ha.role == "leader":
        from ..manager.replication import LeaseKeeper

        lease_keeper = LeaseKeeper(ha)
        lease_keeper.serve()
    elif ha is not None and replicate_from:
        from ..manager.replication import LeaseKeeper, LogFollower

        def _rebuild(_touched) -> None:
            # Replicated rows changed: swap the REST surface onto fresh
            # consumers (their in-memory caches reload from the backend).
            with ha.applying():
                fresh = _build_consumers(
                    cfg, parts["state_backend"], parts["blob_store"]
                )
            rest.registry = fresh["registry"]
            rest.rollout = fresh["rollout"]
            rest.crud = fresh["crud"]
            rest.jobqueue = fresh["jobs"]
            if rest._topology_table is not None:
                with rest._topology_mu:
                    rest.topology_shared = rest._topology_table.load_all()

        def _on_promote() -> None:
            # Now the leader: reconcile as a leader would at boot, start
            # renewing the lease, and let the standing 503 gate fall
            # away (the REST handler reads ha.role per request).
            fresh = _build_consumers(
                cfg, parts["state_backend"], parts["blob_store"]
            )
            fresh["crud"].ensure_default_cluster()
            rest.registry = fresh["registry"]
            rest.rollout = fresh["rollout"]
            rest.crud = fresh["crud"]
            rest.jobqueue = fresh["jobs"]
            keeper = LeaseKeeper(ha)
            keeper.serve()
            serving.lease_keeper = keeper
            print(
                f"manager: promoted to leader (term {ha.term})", flush=True
            )

        follower = LogFollower(
            ha, replicate_from,
            poll_interval_s=cfg.ha.poll_interval_s,
            on_apply=_rebuild,
            on_promote=_on_promote,
        )
    grpc_server = None
    if grpc_mod is not None:
        # Same SHARED rate-limit bucket as REST (qps bounds the service).
        grpc_server = grpc_mod.ManagerGRPCServer(
            parts["registry"], parts["clusters"], parts["searcher"],
            host=cfg.server.host, port=cfg.server.grpc_port,
            # Same RBAC as REST, same credentials: session tokens AND PATs.
            token_verifier=auth.get("token_verifier"),
            users=auth.get("users"),
            rate_limit=bucket,
            ca=ca,
        )
        grpc_server.serve()
    # flush: under a pipe (supervisors, e2e harnesses) the ready line must
    # be visible immediately, not at buffer-fill.
    print(
        f"manager: serving REST on {rest.url}"
        + (f" and grpc on {grpc_server.target}" if grpc_server else "")
        + (
            f" as {parts['ha'].role} (term {parts['ha'].term})"
            if parts["ha"] is not None else ""
        )
        + " (ctrl-c to stop)",
        flush=True,
    )
    serving = ManagerServing(parts=parts, rest=rest, grpc_server=grpc_server,
                             lease_keeper=lease_keeper, follower=follower)
    if follower is not None:
        follower.serve()
    return serving


def run(argv=None) -> int:
    """The binary's body; → exit code."""
    p = base_parser("manager", "Control-plane manager service")
    p.add_argument("--list-models", action="store_true")
    p.add_argument(
        "--replicate-from", default="", metavar="URL",
        help="boot as a hot standby tailing this leader's replication "
             "log; promotes itself when the leader's lease expires",
    )
    args = p.parse_args(argv)
    init_logging(args, "manager")
    debug = init_debug(args)
    init_tracing(args)
    journal = engine = signals = None
    try:
        try:
            cfg = load_config(ManagerConfig, args.config)
            init_flight_recorder(args, cfg.tracing, "manager")
            journal, engine = init_telemetry(args, cfg.telemetry, "manager")
            if not args.list_models:
                signals = SignalWait()
                serving = serve(cfg, replicate_from=args.replicate_from)
        except ConfigError as exc:
            print(f"manager: {exc}", file=sys.stderr)
            return 2
        if args.list_models:
            models = build(cfg, replicate_from=args.replicate_from)["registry"].list()
            if not models:
                print("manager: registry empty")
            for m in models:
                print(
                    f"manager: {m.name} v{m.version} type={m.type} state={m.state.value} "
                    f"scheduler={m.scheduler_id} eval={m.evaluation}"
                )
            return 0
        serving.journal, serving.slo_engine = journal, engine
        signals.wait()
        serving.stop()
        report_launches("manager")
        return 0
    finally:
        if signals is not None:
            signals.close()
        stop_telemetry(journal, engine)
        if debug is not None:
            debug.stop()


if __name__ == "__main__":
    sys.exit(run())
