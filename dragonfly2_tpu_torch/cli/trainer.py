"""trainer service binary (reference: cmd/trainer + trainer/trainer.go).

Port of ``dragonfly2_tpu/cli/trainer.py``.  ``--train-once DIR`` ingests
DIR's columnar shards (``download*.dfc``, ``networktopology*.dfc``), runs
one training round synchronously on ``--device`` (``cuda`` unless asked
for ``cpu``), registers the models and prints what the reference prints.

Without it the binary serves (``serve``): an HTTP ingest server
(``TrainerHTTPServer``) over ``TrainerService(data_dir=cfg.data_dir)``
on ``--device``, registering models through ``RemoteRegistry`` with
``--manager URL`` (or ``manager_addr``) and in an in-process
``ModelRegistry`` otherwise, until SIGINT or SIGTERM; then it stops the
server and exits 0.  With ``lifecycle.enable`` and a REST manager, every
ingested download row also streams into a ``LifecycleDaemon`` (its
``StreamingTrainer`` on ``--device``) that registers candidates as
``--scheduler-id``'s models and begins their rollout through
``RolloutRESTClient``.  A ``grpc://`` manager registers through
``GRPCRemoteRegistry`` (the lifecycle daemon then stays off, as in the
reference: it needs the REST rollout routes), and ``server.grpc_port >= 0``
also serves the gRPC Train stream (``TrainerGRPCServer``); on a machine
without ``grpc`` or ``protobuf`` either exits 2 naming it.

Both modes train on one rank per visible card, as the reference's
trainers span every local device (``create_mesh()``): at one card the
service trains on it alone and makes no process group; at more,
``parallel.launch.RankGroup`` makes this process rank 0 (the server, the
registry and the online sink stay here) and spawns the others, NCCL
between cards.  ``--nproc N`` names the rank count instead; with
``--device cpu``, or more ranks than cards, the ranks form a gloo group
(on the CPU, or sharing ``cuda:0``).  The reference's lines print once,
from rank 0; a round on more than one rank first prints
``trainer: training on N ranks (BACKEND)``.  As in the
reference, ``run`` wires the tracer, the flight recorder, the metric
journal and the SLO engine from the flags and the ``tracing`` and
``telemetry`` sections, and stops the journal and the engine on shutdown.

    python -m dragonfly2_tpu_torch.cli.trainer [--train-once DIR] [--manager URL] \
        [--scheduler-id ID] [--device cpu] [--nproc N]
"""

from __future__ import annotations

import glob
import os
import sys
from dataclasses import dataclass
from typing import Optional

from ..config import ConfigError, TrainerConfigFile, load_config
from ..manager.registry import ModelRegistry
from ..parallel.launch import RankGroup, plan_ranks
from ..trainer.service import TrainerService
from ..trainer.train import TrainConfig
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


def train_config(cfg: TrainerConfigFile) -> TrainConfig:
    """The round's ``TrainConfig`` from the config file's training section."""
    return TrainConfig(
        epochs=cfg.training.epochs,
        learning_rate=cfg.training.learning_rate,
        warmup_steps=cfg.training.warmup_steps,
    )


def model_registry(manager_addr: Optional[str], token: Optional[str], registry=None):
    """Where models register: ``RemoteRegistry`` for a REST manager,
    ``GRPCRemoteRegistry`` for a ``grpc://`` one, else ``registry`` (a
    fresh ``ModelRegistry`` by default)."""
    if manager_addr and manager_addr.startswith("grpc://"):
        return grpc_transport("a grpc:// manager").GRPCRemoteRegistry(
            manager_addr[len("grpc://"):], token=token or ""
        )
    if manager_addr:
        from ..rpc import RemoteRegistry

        return RemoteRegistry(manager_addr, token=token)
    return registry if registry is not None else ModelRegistry()


@dataclass
class TrainerServing:
    """What ``serve`` started, and the metric journal and SLO engine when
    the binary handed them over (``stop()`` stops them last)."""

    service: TrainerService
    http_server: object
    grpc_server: object = None
    lifecycle_daemon: object = None
    journal: object = None
    slo_engine: object = None
    ranks: Optional[RankGroup] = None

    @property
    def url(self) -> str:
        return self.http_server.url

    def stop(self) -> None:
        if self.lifecycle_daemon is not None:
            self.lifecycle_daemon.stop()
        self.http_server.stop()
        if self.grpc_server is not None:
            self.grpc_server.stop()
        if self.ranks is not None:
            self.ranks.close()
        stop_telemetry(self.journal, self.slo_engine)


def rank_group(device, nproc: Optional[int], store_dir: Optional[str]) -> Optional[RankGroup]:
    """The service's ranks: ``None`` at one rank (the one-device path, no
    process group), else a ``RankGroup`` over ``plan_ranks(device,
    nproc)`` with its store under ``store_dir``."""
    plan = plan_ranks(device, nproc)
    if plan.world == 1:
        return None
    print(f"trainer: training on {plan.world} ranks ({plan.backend})", flush=True)
    return RankGroup(plan.world, device=device, store_dir=store_dir)


def serve(
    cfg: Optional[TrainerConfigFile] = None,
    *,
    device="cuda",
    manager: Optional[str] = None,
    manager_token: Optional[str] = None,
    registry=None,
    gnn_model: str = "hop",
    scheduler_id: str = "scheduler-local",
    nproc: Optional[int] = None,
) -> TrainerServing:
    """The binary's serve mode (reference cli/trainer.py:98-176) as a
    composition: ``TrainerHTTPServer`` on ``server.host:server.port`` (0
    binds an ephemeral port) over ``TrainerService(data_dir=cfg.data_dir)``
    training on ``device``.  Models register through ``RemoteRegistry``
    when ``manager`` or ``cfg.manager_addr`` names one, else in
    ``registry`` (a fresh ``ModelRegistry`` by default).  With
    ``lifecycle.enable`` and a REST manager, a ``LifecycleDaemon`` for
    ``scheduler_id`` (the binary's ``--scheduler-id``) is the service's
    online sink and serves on its own thread.  ``gnn_model`` is the
    service's graph branch (``"hop"`` as in the reference binary, or
    ``"gat"``, whose gather's backward is K3).  With ``server.grpc_port >=
    0`` the gRPC Train stream serves the same service.  Rounds train on
    ``nproc`` ranks, by default one per visible card (``rank_group``; the
    FileStore lives in ``cfg.data_dir``; the helpers start before the
    server does); ``stop()`` ends them.  Raises
    ``ConfigError`` naming the package when gRPC is asked for and
    ``grpc`` or ``protobuf`` is missing."""
    cfg = cfg or TrainerConfigFile()
    cfg.validate()
    manager_addr = manager or cfg.manager_addr
    grpc_mod = None
    if cfg.server.grpc_port >= 0:
        grpc_mod = grpc_transport("server.grpc_port >= 0")
    registry = model_registry(manager_addr, manager_token, registry)
    from ..rpc import TrainerHTTPServer

    ranks = rank_group(device, nproc, cfg.data_dir)
    service = TrainerService(
        registry,
        data_dir=cfg.data_dir,
        train_config=train_config(cfg),
        gnn_model=gnn_model,
        device=device,
        ranks=ranks,
    )
    if ranks is not None:
        # Start the helpers now: a rank that cannot start fails the boot,
        # not the first upload.
        ranks.start(service.rank_service_kwargs())
    try:
        http_server = TrainerHTTPServer(service, host=cfg.server.host, port=cfg.server.port)
        http_server.serve()
    except BaseException:
        if ranks is not None:
            ranks.close()
        raise
    serving = TrainerServing(service=service, http_server=http_server, ranks=ranks)
    if grpc_mod is not None:
        serving.grpc_server = grpc_mod.TrainerGRPCServer(
            service, host=cfg.server.host, port=cfg.server.grpc_port
        )
        serving.grpc_server.serve()
    # Self-driving lifecycle plane (DESIGN.md §29): with a REST manager
    # attached, every ingested record also streams into the continuous
    # train→export→rollout loop — candidates register and walk
    # SHADOW→CANARY→ACTIVE with zero human steps (schedulers' rollout
    # reporters supply the evaluation evidence).
    if cfg.lifecycle.enable and manager_addr and not manager_addr.startswith("grpc://"):
        from ..lifecycle import LifecycleConfig, LifecycleDaemon
        from ..rollout.client import RolloutRESTClient

        lc = cfg.lifecycle
        # No StateBackend here (that is the manager's): lifecycle
        # watermarks/lineage live in the daemon's in-memory store, so the
        # epoch cadence holds for the life of this process; the
        # manager-side rollout rows stay durable either way.
        serving.lifecycle_daemon = LifecycleDaemon(
            registry,
            RolloutRESTClient(manager_addr, token=manager_token),
            config=LifecycleConfig(
                scheduler_id=scheduler_id,
                model_name=lc.model_name,
                regions=tuple(lc.regions),
                epoch_records=lc.epoch_records,
                max_steps_per_epoch=lc.max_steps_per_epoch,
                min_joined=lc.min_joined,
                arbitration_margin=lc.arbitration_margin,
                canary_percent=lc.canary_percent,
                interval_s=lc.interval_s,
                trainer_batch_size=lc.trainer_batch_size,
            ),
            device=device,
        )
        service.online_sink = serving.lifecycle_daemon
        serving.lifecycle_daemon.serve()
        print(
            f"trainer: lifecycle daemon on (epoch every {lc.epoch_records} "
            f"records, regions={list(lc.regions) or ['global only']})",
            flush=True,
        )
    elif cfg.lifecycle.enable:
        print(
            "trainer: lifecycle.enable set but no REST manager attached; "
            "lifecycle daemon not started",
            flush=True,
        )
    print(
        f"trainer: ingest on {http_server.url}"
        + (f" and grpc on {serving.grpc_server.target}" if serving.grpc_server else "")
        + f", staging in {cfg.data_dir} (ctrl-c to stop)",
        flush=True,
    )
    return serving


def run(argv=None, *, registry=None) -> int:
    """The binary's body; → exit code.  ``registry`` replaces the
    in-process ``ModelRegistry`` the round registers into (callers that
    read the registered models back pass their own)."""
    p = base_parser("trainer", "Model training service")
    p.add_argument("--train-once", default=None, metavar="DIR",
                   help="ingest DIR's columnar shards, train one round, exit")
    p.add_argument("--scheduler-id", default="scheduler-local")
    p.add_argument("--manager", default=None, metavar="URL",
                   help="remote manager REST URL (models publish there)")
    p.add_argument("--manager-token", default=None, help="bearer token for the manager")
    p.add_argument("--device", default="cuda",
                   help="torch device the trainer trains on (cuda or cpu)")
    p.add_argument("--nproc", type=int, default=None, metavar="N",
                   help="ranks to train on (default: one per visible card; "
                        "gloo with --device cpu or more ranks than cards)")
    args = p.parse_args(argv)
    init_logging(args, "trainer")
    debug = init_debug(args)
    init_tracing(args)
    journal = engine = signals = None
    try:
        try:
            cfg = load_config(TrainerConfigFile, args.config)
            init_flight_recorder(args, cfg.tracing, "trainer")
            journal, engine = init_telemetry(args, cfg.telemetry, "trainer")
            if args.train_once:
                registry = model_registry(
                    args.manager or cfg.manager_addr, args.manager_token, registry
                )
            else:
                signals = SignalWait()
                serving = serve(
                    cfg, device=args.device, manager=args.manager,
                    manager_token=args.manager_token, registry=registry,
                    scheduler_id=args.scheduler_id, nproc=args.nproc,
                )
                serving.journal, serving.slo_engine = journal, engine
        except ConfigError as exc:
            print(f"trainer: {exc}", file=sys.stderr)
            return 2
        if not args.train_once:
            signals.wait()
            serving.stop()
            report_launches("trainer")
            return 0
        ranks = rank_group(args.device, args.nproc, None)
        try:
            return _train_once(args, cfg, registry, ranks)
        finally:
            if ranks is not None:
                ranks.close()
    finally:
        if signals is not None:
            signals.close()
        stop_telemetry(journal, engine)
        if debug is not None:
            debug.stop()


def _train_once(args, cfg: TrainerConfigFile, registry, ranks: Optional[RankGroup]) -> int:
    """``--train-once``: one synchronous round over the directory's shards
    (on ``ranks`` when given) and the reference's lines; → exit code."""
    service = TrainerService(
        registry,
        # --train-once reads local shards (no staging).
        data_dir=None,
        train_config=train_config(cfg),
        device=args.device,
        ranks=ranks,
    )
    session = service.open_train_stream(
        ip="127.0.0.1", hostname=os.uname().nodename, scheduler_id=args.scheduler_id
    )
    dl = sorted(glob.glob(os.path.join(args.train_once, "download*.dfc")))
    topo = sorted(glob.glob(os.path.join(args.train_once, "networktopology*.dfc")))
    if not dl:
        print(f"trainer: no download*.dfc shards in {args.train_once}", file=sys.stderr)
        return 1
    for path in dl:
        session.send_download_shard(path)
    for path in topo:
        session.send_network_topology_shard(path)
    key = session.close_and_train()
    run_rec = service.runs[key]
    if run_rec.error:
        print(f"trainer: run failed: {run_rec.error}", file=sys.stderr)
        return 1
    for name, metrics in run_rec.metrics.items():
        print(
            f"trainer: {name}: mae={metrics.mae:.4f} mse={metrics.mse:.4f} "
            f"f1={metrics.f1:.3f} ({run_rec.download_rows} rows)"
        )
    for mid in run_rec.models:
        m = registry.get(mid)
        print(f"trainer: registered {m.name} v{m.version} ({m.type})")
    return 0


if __name__ == "__main__":
    sys.exit(run())
